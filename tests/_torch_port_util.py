"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded numpy inputs handed to both, weights copied across."""

import numpy as np
import torch

from graphinvent_tpu_torch.models.core import MLP


def seeded(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def mlp_from_jax(params, e=None):
    """A JAX ``init_mlp`` pytree (or tower ``e`` of an ``init_stacked_mlp``
    one) as the port's MLP."""
    layers = params["layers"]
    pick = (lambda a: np.asarray(a)) if e is None else (
        lambda a: np.asarray(a)[e])
    sizes = [pick(layers[0]["w"]).shape[1]] + [pick(lp["w"]).shape[0]
                                                for lp in layers]
    m = MLP(sizes[0], sizes[1:-1], sizes[-1])
    with torch.no_grad():
        for lin, lp in zip(m.linears, layers):
            lin.weight.copy_(torch.from_numpy(pick(lp["w"]).copy()))
            lin.bias.copy_(torch.from_numpy(pick(lp["b"]).copy()))
    return m


def towers_from_jax(params):
    E = np.asarray(params["layers"][0]["w"]).shape[0]
    return torch.nn.ModuleList(mlp_from_jax(params, e) for e in range(E))


def to_np(t):
    return t.detach().float().cpu().numpy()


def bias_head(cfg, params, add_nodes=1, add=6.0, term=8.0):
    """Raises, in a JAX ``init_model`` pytree of numpy arrays, the logits of
    "add an atom to node 0 .. add_nodes-1" and of "terminate": an
    untrained head almost never picks a valid first action, and with this
    one graphs grow for several rounds.  Returns ``params``."""
    head = params["apd"]
    head["f_add_2"]["layers"][-1]["b"][
        :add_nodes * cfg.len_f_add_per_node] += add
    head["f_term_2"]["layers"][-1]["b"][:] += term
    return params


def jax_init(cfg, seed):
    """The JAX package's ``init_model`` params for ``cfg`` from
    ``PRNGKey(seed)``, as (writable) numpy arrays."""
    import jax
    from graphinvent_tpu.models import init_model
    return jax.tree_util.tree_map(
        np.array, init_model(cfg, jax.random.PRNGKey(seed)))
