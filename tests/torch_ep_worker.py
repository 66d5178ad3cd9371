"""A rank of the expert-parallel MoE test (tests/test_torch_moe_ep.py):
joins a gloo group through a file, builds a 1 x n (data x model) CPU mesh,
runs the port's `moe_ffn` on the weights and tokens the test saved, with
and without the mesh, and writes rank 0's outputs.  Imports no JAX."""
import numpy as np
import torch
import torch.distributed as dist


def run(rank: int, world: int, init_file: str, in_path: str, out_path: str):
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        from repro_torch import interop
        from repro_torch.distributed.sharding import use_mesh
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import moe
        data = np.load(in_path, allow_pickle=True)
        cfg = interop.model_config_from_dict(data["cfg"].item())
        p = moe.MoE(*(torch.from_numpy(data[k]) for k in ("router", "wi", "wo")))
        x = torch.from_numpy(data["x"])
        mesh = make_mesh((1, world), ("data", "model"), device_type="cpu")
        with use_mesh(mesh):
            y_ep = moe.moe_ffn(cfg, p, x)
        y_local = moe.moe_ffn(cfg, p, x)
        # the gradient through the branch (the training step's path)
        xg = x.clone().requires_grad_(True)
        with use_mesh(mesh):
            g_ep, = torch.autograd.grad(moe.moe_ffn(cfg, p, xg).sum(), xg)
        xg = x.clone().requires_grad_(True)
        g_local, = torch.autograd.grad(moe.moe_ffn(cfg, p, xg).sum(), xg)
        if rank == 0:
            np.savez(out_path, ep=y_ep.detach().numpy(), local=y_local.numpy(),
                     g_ep=g_ep.numpy(), g_local=g_local.numpy())
    finally:
        dist.destroy_process_group()
