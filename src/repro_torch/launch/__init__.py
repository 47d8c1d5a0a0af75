"""Launch layer on PyTorch: the step builders (``steps``), the serving
driver (``serve``) and the training driver (``train``).

The reference's TPU launch tooling (dry-run, HLO, roofline, sharding plans,
meshes) is not ported yet (ROADMAP A15).
"""
