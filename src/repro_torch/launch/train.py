"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.
The port of :mod:`repro.launch.train`.

Trains on ``--device`` (``cuda`` by default; no fallback) from weights
initialised from a generator seeded 0, with float32 AdamW moments and a
warmup of a tenth of the steps, as the reference's launcher.  ``--reduced``
(the default) runs the config's tiny smoke-test variant and
``--no-reduced`` the published config; the reference's flag cannot be
cleared, so it always trains the reduced one.  ``--use-mesh`` trains under a
``("data", "model")`` mesh over the ranks of the process group that is up
(``launch/mesh.make_host_mesh``; with none, a one-rank group on
``--device``, which the launcher ends when it is done).
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.distributed.sharding import set_mesh
from repro_torch.kernels._build import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LMModel
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainConfig, train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="the config's reduced smoke-test variant (--no-reduced: "
                         "the published config)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--use-mesh", action="store_true",
                    help="build a host mesh over the ranks of the process group")
    ap.add_argument("--device", default="cuda", help="where the model trains")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    if not args.use_mesh:
        return _train(args, cfg, dev)
    started = not dist.is_initialized()
    set_mesh(make_host_mesh(device=dev))
    try:
        return _train(args, cfg, dev)
    finally:
        set_mesh(None)
        if started:
            dist.destroy_process_group()


def _train(args, cfg, dev) -> dict:
    model = LMModel(cfg, device=dev)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch))
    opt = AdamWConfig(lr=args.lr, state_dtype=torch.float32,
                      warmup_steps=max(args.steps // 10, 1), total_steps=args.steps)
    tcfg = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, accum=args.accum)

    def log(step, m):
        if step % 10 == 0:
            print(f"step {step:5d} loss={m['loss']:.4f} gnorm={m['grad_norm']:.3f} "
                  f"{m['step_time_s'] * 1e3:.0f}ms")

    out = train(model, pipe.batch_at, opt, tcfg, on_step=log)
    print(f"done: loss {out['history'][0]['loss']:.3f} -> {out['history'][-1]['loss']:.3f} "
          f"on {dev}")
    return out


if __name__ == "__main__":
    main()
