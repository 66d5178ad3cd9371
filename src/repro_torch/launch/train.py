"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        --reduced --device cpu --steps 5

Without `--device` it runs on the CUDA device (and fails without one).
Weights are random, drawn from seed 0; a run resumes from the latest
checkpoint in `--ckpt-dir`.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="width/depth-reduced config")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_ckpt in the temporary directory")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core.api import resolve_device
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device, "repro_torch.launch.train")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ocfg = AdamWConfig(total_steps=args.steps)
    pipe = TokenPipeline(cfg.vocab_size, batch=args.batch, seq_len=args.seq,
                         frontend_tokens=cfg.num_frontend_tokens,
                         d_model=cfg.d_model,
                         frames=cfg.encoder_len if cfg.is_encoder_decoder else 0)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         microbatches=args.microbatches)
    Trainer(cfg, ocfg, tcfg, pipe, device=device).run()


if __name__ == "__main__":
    main()
