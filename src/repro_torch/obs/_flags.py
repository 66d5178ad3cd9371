"""The one mutable observability switch, isolated so every obs submodule
(and every instrumented hot path) can read it without import cycles.

`repro_torch.obs.configure(enabled=...)` is the only writer.  Disabled is the
default: instrumentation sites collapse to a single module-attribute
check, so a store built without `obs.configure(enabled=True)` runs the
exact pre-observability code path (the bit-exactness the acceptance
suite pins)."""

ENABLED = False
