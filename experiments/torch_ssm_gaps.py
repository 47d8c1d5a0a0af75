#!/usr/bin/env python3
"""Measure the state-space families' numerical gaps on the CPU, port against reference.

    PYTHONPATH=src python3 experiments/torch_ssm_gaps.py [--seeds 10]

Three measurements at the smoke configs of falcon-mamba-7b (Mamba-1) and
zamba2-7b (Mamba-2 with its shared attention block), with the reference's
``init`` weights carried into the port:

1. bfloat16: the largest |Δ| between the port's and the reference's
   prefill logits, one teacher-forced decode step's logits and the loss,
   over ``--seeds`` batch seeds (2, 3, ...) at the shapes of
   ``tests/test_torch_models_ssm.py``; its tolerances come from these.
2. float32 teacher forcing at 1,024 tokens with the full configs' chunks
   (512 for Mamba-1, 256 for the SSD): |prefill(1,024) - (prefill(1,023) +
   a decode step)| in each package; 1,023 tokens take the one-chunk
   fallback, as in ``chip_smoke.py``'s full-width check.
3. The same gap in float64: a copy of ``repro_torch`` under
   ``build/ssm_float64/`` with every float32 island made float64, run in a
   child process. A gap near float64 rounding there says that the float32
   gap of (2) is rounding, not a fault of the algorithm.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ARCHS = {"falcon-mamba-7b": {"scan_chunk": 512}, "zamba2-7b": {"ssm_chunk": 256}}
N_FORCED = 1024

FORCED_GAP = """
import ast, dataclasses, sys
import numpy as np, torch
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
arch, n, chunks = sys.argv[1], int(sys.argv[2]), ast.literal_eval(sys.argv[3])
cfg = dataclasses.replace(get_smoke_config(arch), dtype="float64", param_dtype="float64", **chunks)
model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
tokens = np.random.default_rng(7).integers(0, cfg.vocab, (1, n)).astype(np.int32)
full, _ = model.prefill({"tokens": tokens})
_, cache = model.prefill({"tokens": tokens[:, :-1], "max_seq": n})
step, _ = model.decode_step(cache, tokens[:, -1], n - 1)
print(float((step - full)[:, :cfg.vocab].abs().max()), step.dtype)
"""


def bf16_gaps(n_seeds: int) -> None:
    sys.path.insert(0, str(REPO / "tests"))
    import test_torch_models_ssm as T

    for arch in ARCHS:
        _, _, params = T.reference_params(arch, "float32")
        worst: dict = {}
        for seed in range(2, 2 + n_seeds):
            original = T.make_batch
            T.make_batch = lambda cfg, _s, _seed=seed: original(cfg, _seed)
            try:
                got = T.run_bf16(arch, params)
            finally:
                T.make_batch = original
            for what, (r, p) in got.items():
                worst[what] = max(worst.get(what, 0.0), float(np.abs(T.as_np(p) - T.as_np(r)).max()))
        print(f"bfloat16 {arch}: max |Δ| over seeds 2-{1 + n_seeds}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in worst.items()), flush=True)


def forced_gaps_float32() -> None:
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_smoke_config
    from repro.models import build_model as ref_build_model
    from repro_torch.configs import get_smoke_config as port_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_jax

    for arch, chunks in ARCHS.items():
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **chunks)
        api = ref_build_model(cfg)
        params = jax.jit(api.init)(jax.random.key(0))
        tokens = np.random.default_rng(7).integers(0, cfg.vocab, (1, N_FORCED)).astype(np.int32)
        full, _ = api.prefill(params, {"tokens": jnp.asarray(tokens)})
        _, cache = api.prefill(params, {"tokens": jnp.asarray(tokens[:, :-1]), "max_seq": N_FORCED})
        step, _ = api.decode_step(params, cache, jnp.asarray(tokens[:, -1]), jnp.int32(N_FORCED - 1))
        ref_gap = float(np.abs(np.asarray(step) - np.asarray(full))[:, :cfg.vocab].max())
        pcfg = dataclasses.replace(port_smoke_config(arch), dtype="float32", **chunks)
        model = build_model(pcfg, "cpu")
        model.load_state_dict(params_from_jax(pcfg, jax.tree.map(np.asarray, params)))
        with torch.no_grad():
            p_full, _ = model.prefill({"tokens": tokens})
            _, p_cache = model.prefill({"tokens": tokens[:, :-1], "max_seq": N_FORCED})
            p_step, _ = model.decode_step(p_cache, tokens[:, -1], N_FORCED - 1)
        port_gap = float((p_step - p_full)[:, :cfg.vocab].abs().max())
        print(f"float32 teacher forcing at {N_FORCED} tokens {arch} {chunks}: reference {ref_gap:.3g}, "
              f"port {port_gap:.3g}", flush=True)


def forced_gaps_float64() -> None:
    dst = REPO / "build" / "ssm_float64"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(REPO / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("ssm.py", "layers.py", "model.py"):
        path = dst / "repro_torch" / "models" / name
        text = re.sub(r"\.float\(\)", ".double()", path.read_text()).replace("torch.float32", "torch.float64")
        path.write_text(text)
    env = dict(os.environ, PYTHONPATH=str(dst))
    for arch, chunks in ARCHS.items():
        out = subprocess.run([sys.executable, "-c", FORCED_GAP, arch, str(N_FORCED), repr(chunks)],
                             env=env, capture_output=True, text=True, check=True, timeout=900)
        print(f"float64 copy, teacher forcing at {N_FORCED} tokens {arch} {chunks}: {out.stdout.strip()}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO / "src"))
    bf16_gaps(args.seeds)
    forced_gaps_float32()
    forced_gaps_float64()
    return 0


if __name__ == "__main__":
    sys.exit(main())
