"""Golden outputs of `skyhdr`'s serving forward for the PyTorch port.

Runs `skyhdr.train.engine.make_inference_fn` on the CPU at 16x64 with the
distortion-aware conv (the XLA gather path), weights from
`skyhdr_torch.utils.transplant.init_model_vars(cfg, seed)` and a seeded
numpy input, and saves what the port is held to:

    python tools/make_torch_golden.py   # -> tests/fixtures/torch_golden_da_16x64.npz

`tests/test_torch_slice.py` regenerates it and checks it against the file;
`chip_smoke.py` holds the port's CUDA run to it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_golden_da_16x64.npz")
H, W, BATCH = 16, 64, 2


def golden_config():
    from skyhdr_torch.config import Config, DataConfig, ModelConfig

    return Config(model=ModelConfig(im_height=H, im_width=W, use_da_conv=True,
                                    da_backend="xla"),
                  data=DataConfig(batch_size=BATCH))


def golden_input(seed: int) -> np.ndarray:
    return np.random.default_rng(seed + 1).uniform(
        0.0, 1.0, (BATCH, H, W, 3)).astype(np.float32)


def make_golden(seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from skyhdr.config import Config, DataConfig, ModelConfig
    from skyhdr.train.engine import make_inference_fn
    from skyhdr_torch.utils.transplant import init_model_vars, tree_digest

    tcfg = golden_config()
    cfg = Config(model=ModelConfig(**vars(tcfg.model)),
                 data=DataConfig(batch_size=BATCH))
    gen_vars, sun_vars = init_model_vars(tcfg, seed)
    x = golden_input(seed)
    out = make_inference_fn(cfg)(gen_vars, sun_vars, jnp.asarray(x))
    return {
        "seed": np.int64(seed),
        "weights_digest": np.float64(tree_digest({"gen": gen_vars,
                                                  "sun": sun_vars})),
        "input": x,
        "y_final_lin": np.asarray(out["y_final_lin"]),
        "sunpose_pred": np.asarray(out["sunpose_pred"]),
        "alpha": np.asarray(out["alpha"]),
    }


def main():
    sys.path.insert(0, ROOT)
    golden = make_golden(0)
    np.savez_compressed(FIXTURE, **golden)
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")


if __name__ == "__main__":
    main()
