"""Helpers shared by the parity tests of the PyTorch port (not a test module).

The same numpy inputs, made from a seed, go through a JAX function and its
port; both results come back as numpy arrays for comparison.  Torch runs on
one thread: the suite runs under several xdist workers on one host.
"""

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)


def to_numpy(x):
    """A result (array, tensor, or a tuple of them) as numpy arrays."""
    if isinstance(x, tuple):
        return tuple(to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_both(jax_fn, torch_fn, *np_inputs):
    """``(jax_fn(*inputs), torch_fn(*inputs))`` as numpy, the inputs handed
    to each framework as its own arrays."""
    j = jax_fn(*(jnp.asarray(a) for a in np_inputs))
    t = torch_fn(*(torch.from_numpy(np.array(a)) for a in np_inputs))
    return to_numpy(j), to_numpy(t)
