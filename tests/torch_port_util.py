"""Shared helpers of the port's differential tests (tests/test_torch_*.py):
the same numpy inputs go to the JAX package and to orb_slam_tpu_torch on
the CPU, and the outputs come back as numpy arrays."""
import numpy as np
import torch


def np_of(x):
    """numpy view of a torch tensor or JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t_of(a, dtype=None):
    """CPU tensor of a numpy (or JAX) array."""
    t = torch.from_numpy(np.array(np.asarray(a)))
    return t if dtype is None else t.to(dtype)


def desc_bits(a, b):
    """Differing bits per row of two [N, 8] 32-bit descriptor tables
    (uint32 or int32 views of the same words)."""
    x = np.bitwise_xor(np.asarray(a).view(np.uint32),
                       np.asarray(b).view(np.uint32))
    return np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)


def jax_draws(key, valid, n_samples):
    """The JAX package's Sim3 RANSAC minimal sets for `key`
    (orb_slam_tpu/solvers/sim3_solver.py:62-68): [n_samples, 3] indices of
    valid rows, weighted by the valid mask, without replacement."""
    import jax
    import jax.numpy as jnp
    n = valid.shape[0]
    w = jnp.asarray(valid).astype(jnp.float32)
    p = w / jnp.maximum(jnp.sum(w), 1.0)
    keys = jax.random.split(key, n_samples)
    return np.array(jax.vmap(lambda k: jax.random.choice(
        k, n, shape=(3,), replace=False, p=p))(keys))
