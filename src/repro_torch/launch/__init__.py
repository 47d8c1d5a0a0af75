"""Launch layer on PyTorch: the serving steps and driver (``steps``, ``serve``).

The reference's TPU launch tooling (dry-run, HLO, roofline, sharding plans,
meshes) and its training driver are not ported yet (ROADMAP A15, A14c).
"""
