"""The port's OneCycle schedule and Adam against
``graphinvent_tpu.train.optim``.

Tolerances: the JAX schedule is evaluated in f32 on the device, the port's
in Python floats on the host, so lr and beta1 agree to rtol 1e-5; 20 Adam
steps with a cycling beta1 agree with ``adam_update`` to rtol 1e-5 (the
port divides sqrt(nu) by sqrt(bc2) where JAX takes sqrt(nu / bc2)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphinvent_tpu.config import test_config as jax_tiny
from graphinvent_tpu.train import optim as joptim

from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.models.core import MLP
from graphinvent_tpu_torch.train import optim as poptim

SCHEDULES = {
    "train": dict(max_lr=1e-4, total_steps=50),
    "train-no-cycle": dict(max_lr=1e-4, total_steps=50, cycle_momentum=False),
    "fine-tune": dict(max_lr=1e-4, total_steps=40, pct_start=0.05,
                      div_factor=1.0, final_div_factor=1e4),
    "short": dict(max_lr=3e-3, total_steps=2),
}
STEPS = [0, 1, 2, 7, 13, 14, 15, 25, 48, 49, 50, 51, 500]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_onecycle_eval_matches_jax_incl_past_total_steps(name):
    kw = SCHEDULES[name]
    jsched, psched = joptim.OneCycle(**kw), poptim.OneCycle(**kw)
    for step in STEPS:
        jlr, jb1 = jsched(step)
        lr, b1 = psched(step)
        assert isinstance(lr, float) and isinstance(b1, float)
        np.testing.assert_allclose(lr, float(jlr), rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(b1, float(jb1), rtol=1e-5)
    # past the plan the schedule clips and stays at its final value
    assert psched(10 * kw["total_steps"]) == psched(100 * kw["total_steps"])


@pytest.mark.parametrize("job_type,kw", [
    ("train", {}), ("train", {"schedule_epochs": 7}),
    ("fine-tune", {}), ("fine-tune", {"schedule_epochs": 30}),
])
def test_onecycle_for_config_matches_jax(job_type, kw):
    # a score valid at max_n_nodes=13, which a fine-tune config requires
    extra = dict(score_components=("target_size=10",),
                 score_thresholds=(0.0,)) if job_type == "fine-tune" else {}
    jcfg = jax_tiny("GGNN", job_type=job_type, epochs=5, **kw, **extra)
    pcfg = port_tiny("GGNN", device="cpu", job_type=job_type, epochs=5,
                     **kw, **extra)
    want = joptim.onecycle_for_config(jcfg, 11)
    got = poptim.onecycle_for_config(pcfg, 11)
    for field in ("max_lr", "total_steps", "pct_start", "div_factor",
                  "final_div_factor", "base_momentum", "max_momentum",
                  "cycle_momentum"):
        assert getattr(got, field) == getattr(want, field), field


def _mlp_and_tree(seed):
    m = MLP(5, [7, 6], 3, generator=torch.Generator().manual_seed(seed))
    tree = {n: jnp.array(p.detach().numpy().copy())
            for n, p in m.named_parameters()}
    return m, tree


def test_adam_20_steps_with_cycling_beta1_match_jax():
    model, params = _mlp_and_tree(0)
    adam = poptim.Adam(model)
    state = joptim.adam_init(params)
    sched = poptim.OneCycle(max_lr=1e-2, total_steps=20)
    jsched = joptim.OneCycle(max_lr=1e-2, total_steps=20)
    rng = np.random.default_rng(0)
    versions = [p._version for p in adam.params]
    for step in range(20):
        grads = {n: rng.normal(size=tuple(p.shape)).astype(np.float32)
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        lr, b1 = sched(adam.step)
        jlr, jb1 = jsched(state.step)
        adam.update(lr, b1)
        params, state = joptim.adam_update(
            {n: jnp.asarray(g) for n, g in grads.items()}, state, params,
            jlr, jb1)
    assert adam.step == int(state.step) == 20
    for i, (n, p) in enumerate(model.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]),
                                   rtol=1e-5, atol=1e-7, err_msg=n)
        # moments of O(1) gradients: entries near zero carry the f32
        # rounding of the O(1) terms that cancelled
        np.testing.assert_allclose(adam.mu[i].numpy(),
                                   np.asarray(state.mu[n]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(adam.nu[i].numpy(),
                                   np.asarray(state.nu[n]), rtol=1e-5,
                                   atol=1e-7)
    # in-place updates: same storage, version counters moved (the fused
    # kernel's weight cache keys on them)
    assert all(p._version > v for p, v in zip(adam.params, versions))


def test_adam_refuses_a_missing_gradient():
    model, _ = _mlp_and_tree(1)
    adam = poptim.Adam(model)
    with pytest.raises(RuntimeError, match="no gradient"):
        adam.update(1e-3)


def test_adam_state_dict_round_trip():
    model, _ = _mlp_and_tree(2)
    adam = poptim.Adam(model)
    for p in adam.params:
        p.grad = torch.ones_like(p)
    adam.update(1e-3, 0.9)
    state = adam.state_dict()
    assert state["step"] == 1 and sorted(state["mu"]) == sorted(adam.names)
    other = poptim.Adam(MLP(5, [7, 6], 3))
    other.load_state_dict(state)
    assert other.step == 1
    for a, b in zip(adam.mu + adam.nu, other.mu + other.nu):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="does not match"):
        poptim.Adam(MLP(5, [7], 3)).load_state_dict(state)
