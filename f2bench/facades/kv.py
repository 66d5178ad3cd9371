"""The single store: `repro_torch.KV` built from a configuration file.

`build(F2Config, conf, mix, device)` returns the store; `counters(store)`
the program's own counters that the per-layer metrics read."""


def build(cfg, conf, mix, device):
    from repro_torch import KV
    return KV(cfg, device=device, **conf["facade_args"])


def counters(store) -> dict:
    return dict(read_ops=store.io_stats()["read_ops"])
