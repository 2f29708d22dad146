"""Shared by the ``test_torch_*`` parity tests: fixed dropout for the
reference's flax model, and the reference's AlexNet3D at a test volume."""

import contextlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch


@contextlib.contextmanager
def torch_threads(n: int = 2):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def fixed_dropout(masks: dict[str, np.ndarray]):
    """Context in which every training-mode ``nn.Dropout`` of a flax model
    applies the given keep-mask (by module name, e.g. ``Dropout_0``)
    instead of drawing one; under ``vmap``/``scan`` it is one constant for
    every client and step. Deterministic calls pass through."""
    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dropout) and context.method_name == "__call__":
            x = args[0]
            det = nn.merge_param("deterministic", mod.deterministic,
                                 kwargs.get("deterministic"))
            if det or mod.rate == 0:
                return x
            keep = jnp.asarray(masks[mod.name])
            return jnp.where(keep, x / (1.0 - mod.rate), jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    return nn.intercept_methods(intercept)


def dropout_masks(batch: int, flat: int, seed: int = 0):
    """Keep-masks for AlexNet3D's two dropouts at ``batch`` rows: numpy for
    the reference (by module name) and torch for the port (in order)."""
    rng = np.random.default_rng(seed)
    m0 = rng.random((batch, flat)) < 0.5
    m1 = rng.random((batch, 64)) < 0.5
    return ({"Dropout_0": m0, "Dropout_1": m1},
            (torch.from_numpy(m0), torch.from_numpy(m1)))


def jax_alexnet(shape, seed: int = 0, **optim_kw):
    """The reference's AlexNet3D trainer and its initial (params,
    batch_stats) as numpy trees, for volumes of ``shape``."""
    from neuroimagedisttraining_tpu.config import OptimConfig
    from neuroimagedisttraining_tpu.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu.models import create_model

    model = create_model("3dcnn", num_classes=1, remat=False)
    trainer = LocalTrainer(model, OptimConfig(**optim_kw), num_classes=1)
    cs = trainer.init_client_state(jax.random.key(seed),
                                   jnp.zeros((1,) + tuple(shape)))
    return (trainer, jax.tree.map(np.asarray, cs.params),
            jax.tree.map(np.asarray, cs.batch_stats))
