"""Serving driver: batched prefill + greedy decode over any ported arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-34b --smoke \\
        --batch 4 --prompt-len 32 --gen 16 [--device cuda]

The counterpart of ``repro.launch.serve``, with ``--device`` (the CUDA card
unless ``cpu`` is asked for). Weights are drawn from a seeded generator, as
the reference's are. Times on the card come from CUDA events; on the CPU
from the host clock.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import Model, build_model


class _Timer:
    """Milliseconds between ``start`` and ``stop``: CUDA events on a card,
    the host clock (after nothing to wait for) on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self.t0.elapsed_time(t1)
        return (time.perf_counter() - self.t0) * 1e3


def greedy(model: Model, batch: Dict, gen: int) -> Dict:
    """Prefill ``batch["tokens"]`` (B, S), then ``gen - 1`` greedy decode
    steps over ``logits[:, :vocab]``: the generated ids (B, gen), the last
    step's logits and the prefill's and the decode loop's milliseconds."""
    vocab = model.cfg.vocab
    s = batch["tokens"].shape[1]
    prefill = make_prefill_step(model, s + gen)
    decode = make_decode_step(model)
    timer = _Timer(model.device)
    with torch.no_grad():
        timer.start()
        logits, cache = prefill(batch)
        tok = torch.argmax(logits[:, :vocab], dim=-1)
        prefill_ms = timer.stop()
        out = [tok]
        timer.start()
        for i in range(gen - 1):
            logits, cache = decode(cache, tok, s + i)
            tok = torch.argmax(logits[:, :vocab], dim=-1)
            out.append(tok)
        decode_ms = timer.stop()
    return {"tokens": torch.stack(out, dim=1).cpu().numpy(), "logits": logits,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = torch.device(args.device)
    model = build_model(cfg, device)
    model.init(torch.Generator(device).manual_seed(0))
    rng = np.random.default_rng(0)

    b, s = args.batch, args.prompt_len
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["enc_embed"] = np.zeros((b, cfg.enc_seq, cfg.d_model), np.float32)
    if cfg.family == "vlm":
        batch["img_embed"] = np.zeros((b, cfg.n_img_tokens, cfg.d_model), np.float32)

    out = greedy(model, batch, args.gen)
    print(f"prefill: batch={b} prompt={s} in {out['prefill_ms']:.0f} ms")
    steps = args.gen - 1
    print(f"decode: {steps} steps in {out['decode_ms']:.0f} ms "
          f"({out['decode_ms'] / max(steps, 1):.1f} ms/token/batch)")
    print("generated token ids (first sequence):", out["tokens"][0].tolist())
    return out["tokens"]


if __name__ == "__main__":
    main()
