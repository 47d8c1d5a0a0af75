"""Training driver: config-driven, fault-tolerant, fed by an interest-filtered
replica (the counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --smoke --steps 30 --device cpu --ckpt-dir /tmp/irap_train

The reference's arguments plus ``--device`` (the CUDA card unless ``cpu``
is asked for) and ``--ckpt-every`` (the reference's cadence of 10 steps
unless given: a full-width model's snapshot is tens of GB). The model runs
eagerly on one device; the reference's mesh and sharding plan are its TPU
launch tooling (ROADMAP A15). Weights are drawn from a seeded generator.
``build_data`` keeps an ``IrapEngine`` subscription on ``device`` fresh
every 50 batches (the triple-match and probe kernels on the card) and
yields the reference's batches.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core import InterestExpr, IrapEngine, StepCapacities
from repro_torch.data import DBpediaLikeGenerator, GeneratorConfig, ReplicaTokenPipeline, Verbalizer
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import AdamW, cosine_warmup
from repro_torch.runtime import Trainer, TrainerConfig


def build_data(cfg, batch, seq, device=None):
    gen = DBpediaLikeGenerator(GeneratorConfig(seed=13))
    gen.initial_dump()
    engine = IrapEngine(gen.dict, device=device)
    expr = InterestExpr.parse(
        "g", "t",
        bgp=[("?f", "rdf:type", "dbo:SoccerPlayer"),
             ("?f", "foaf:name", "?n"),
             ("?f", "dbo:team", "?t"),
             ("?t", "rdfs:label", "?tn")],
    )
    sub = engine.register_interest(
        expr,
        StepCapacities(n_removed=1024, n_added=2048, tau=1 << 15,
                       rho=1 << 15, pulls=1 << 15, fanout=8),
        initial_target=gen.slice_for(
            lambda t: t[0].startswith(("dbr:Athlete", "dbr:Team"))),
    )
    verb = Verbalizer(vocab=cfg.vocab, dictionary=gen.dict)
    pipe = ReplicaTokenPipeline(verb, batch_size=batch, seq_len=seq)
    pipe.refresh(sub.tau)

    def it():
        n = 0
        while True:
            n += 1
            if n % 50 == 0:
                d_np, a_np = gen.changeset()
                sub.apply(d_np, a_np)
                pipe.refresh(sub.tau)
            b = next(pipe)
            if cfg.family == "encdec":
                b["enc_embed"] = np.zeros(
                    (batch, cfg.enc_seq, cfg.d_model), np.float32)
            if cfg.family == "vlm":
                b["img_embed"] = np.zeros(
                    (batch, cfg.n_img_tokens, cfg.d_model), np.float32)
            yield b

    return it()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="/tmp/irap_launch_train_torch")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = torch.device(args.device)
    model = build_model(cfg, device)
    opt = AdamW(learning_rate=cosine_warmup(1e-3, 10, args.steps),
                weight_decay=0.01, max_grad_norm=1.0)

    def init_state():
        model.init(torch.Generator(device).manual_seed(0))
        return model, opt.init(dict(model.named_parameters()))

    data = build_data(cfg, args.batch, args.seq, device)
    tr = Trainer(
        make_train_step(model, opt), init_state, data,
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
    )
    print(f"arch={cfg.name} params={cfg.n_params/1e6:.2f}M resume_step={tr.step}")
    hist = tr.run(args.steps, inject_failure_at=args.inject_failure_at)
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"({np.mean([h['dt'] for h in hist]):.3f} s/step)")
    return hist


if __name__ == "__main__":
    main()
