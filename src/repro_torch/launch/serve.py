"""Serving launcher (continuous batching over the F2-paged KV cache).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --reduced --device cpu --backend paged --requests 8

Without `--device` it runs on the CUDA device (and fails without one).
Weights are random, drawn from seed 0.  The paged backend serves the dense
and vlm families; moe, hybrid, audio and ssm archs need `--backend
contiguous` (Whisper's cross-attention cache then stays at zeros, as the
reference's engine leaves it).
"""
import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--backend", default="paged",
                    choices=["paged", "contiguous"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.core.api import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    from repro_torch.serve.engine import Engine, Request

    device = resolve_device(args.device, "repro_torch.launch.serve")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(0)
    model = tf.init_params(cfg, gen, device)
    eng = Engine(cfg, model, max_batch=4, max_len=256, backend=args.backend,
                 device=device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(4, 24)) if args.backend == "paged" else 8
        eng.submit(Request(rid=i,
                           prompt=rng.integers(1, cfg.vocab_size,
                                               plen).astype(np.int32),
                           max_new_tokens=args.max_new_tokens))
    fin = eng.run()
    for r in sorted(fin, key=lambda r: r.rid):
        print(f"req {r.rid}: {r.out_tokens}")
    if args.backend == "paged":
        print(f"demotions={eng.pkv.demotions} promotions={eng.pkv.promotions}"
              f" cold_reads={int(eng.pkv.state.cold_reads)}")


if __name__ == "__main__":
    main()
