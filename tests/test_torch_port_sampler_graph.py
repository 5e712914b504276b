"""The host side of the sampler's captured round
(``sampling/round_graphs.py``) on the CPU: the cache key, the rule on which
hooks keep the eager loop, the forward hooks a replay calls, and the launch
crediting of ``models/fused_enn.py``.  Capture and replay need the card:
``tests/test_torch_port_gpu.py`` holds them against the eager loop there.
"""

import numpy as np
import pytest
import torch

from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.models import build_model, fused_enn
from graphinvent_tpu_torch.sampling import GraphSampler
from graphinvent_tpu_torch.sampling import round_graphs as rg
from graphinvent_tpu_torch.sampling.generator import (
    RoundState, batch_generator,
)

import _torch_port_util  # noqa: F401  (caps torch's threads)

CPU = torch.device("cpu")


def _model(name="GGNN", **kw):
    cfg = port_tiny(name, device="cpu", **kw)
    return cfg, build_model(cfg, torch.Generator().manual_seed(0)).eval()


def _key(cfg, model, batch=8):
    return rg.round_key(cfg, model, batch, CPU)


# --------------------------------------------------------------------------
# the cache key
# --------------------------------------------------------------------------

def test_key_is_stable_across_forwards_and_eager_sampling():
    cfg, model = _model()
    key = _key(cfg, model)
    sampler = GraphSampler(cfg, 8, device=CPU)
    sampler.sample_packed(model, batch_generator(0, 0, CPU))
    with torch.inference_mode():
        nodes = torch.zeros(4, cfg.max_n_nodes, cfg.n_node_features)
        edges = torch.zeros(4, cfg.max_n_nodes, cfg.max_n_nodes,
                            cfg.n_edge_features)
        model(nodes, edges)
    assert _key(cfg, model) == key
    assert sampler._graphs.captures == 0   # the CPU keeps the eager loop


def test_key_moves_on_an_in_place_edit():
    cfg, model = _model()
    key = _key(cfg, model)
    with torch.no_grad():
        model.APDReadout.fTermNet2.linears[-1].bias.add_(1.0)
    moved = _key(cfg, model)
    assert moved != key and moved.versions != key.versions
    assert moved._replace(versions=key.versions) == key


def test_key_moves_on_a_replaced_parameter():
    cfg, model = _model()
    key = _key(cfg, model)
    lin = model.APDReadout.fTermNet2.linears[-1]
    old = lin.bias                     # alive, so its address is not reused
    lin.bias = torch.nn.Parameter(old.detach().clone())
    assert _key(cfg, model).weights != key.weights


def test_key_moves_on_a_cfg_swap_and_the_sampler_cfg_batch_and_modes():
    cfg, model = _model()
    key = _key(cfg, model)
    model.cfg = cfg.replace(fused_inference_enn=False)
    assert _key(cfg, model).model_cfg != key.model_cfg
    model.cfg = cfg
    assert _key(cfg, model) == key
    assert _key(cfg.replace(max_n_nodes=cfg.max_n_nodes + 1), model) != key
    assert _key(cfg, model, batch=9) != key
    with torch.inference_mode():
        assert _key(cfg, model).modes != key.modes
    with torch.no_grad():
        assert _key(cfg, model).modes != key.modes


def test_key_of_inference_tensors_keeps_the_cached_flat_rule():
    """Parameters made under ``inference_mode`` track no version: an edit
    in place leaves the key as it was (replace them, do not edit them),
    and a replaced one moves it."""
    cfg = port_tiny("GGNN", device="cpu")
    with torch.inference_mode():
        model = build_model(cfg, torch.Generator().manual_seed(0)).eval()
        key = _key(cfg, model)
        lin = model.APDReadout.fTermNet2.linears[-1]
        lin.bias.add_(1.0)
        assert _key(cfg, model) == key and set(key.versions) == {-1}
        old = lin.bias
        lin.bias = torch.nn.Parameter(old.clone(), requires_grad=False)
        assert _key(cfg, model).weights != key.weights


# --------------------------------------------------------------------------
# which hooks keep the eager loop
# --------------------------------------------------------------------------

def test_forward_hooks_of_the_model_itself_are_graphed_on_the_same_key():
    """The model's own forward hooks run between the forward's replay and
    the rest's: registering one neither forces the eager loop nor moves
    the key (so no capture of its own)."""
    cfg, model = _model()
    key = _key(cfg, model)
    handle = model.register_forward_hook(lambda m, a, o: None)
    try:
        assert not rg.keeps_eager_loop(model)
        assert _key(cfg, model) == key
    finally:
        handle.remove()


@pytest.mark.parametrize("where", ["pre-hook", "submodule", "submodule pre",
                                   "global", "global pre"])
def test_hooks_that_keep_the_eager_loop(where):
    cfg, model = _model()
    sub = model.APDReadout
    nn_module = torch.nn.modules.module
    handle = {
        "pre-hook": lambda: model.register_forward_pre_hook(
            lambda m, a: None),
        "submodule": lambda: sub.register_forward_hook(
            lambda m, a, o: None),
        "submodule pre": lambda: sub.register_forward_pre_hook(
            lambda m, a: None),
        "global": lambda: nn_module.register_module_forward_hook(
            lambda m, a, o: None),
        "global pre": lambda: nn_module.register_module_forward_pre_hook(
            lambda m, a: None),
    }[where]()
    try:
        assert rg.keeps_eager_loop(model)
    finally:
        handle.remove()
    assert not rg.keeps_eager_loop(model)
    assert rg.keeps_eager_loop({"not": "a module"})


def _state(cfg, B=3, seed=0):
    rng = np.random.default_rng(seed)
    N, Fn, E = cfg.max_n_nodes, cfg.n_node_features, cfg.n_edge_features
    nodes = torch.from_numpy(rng.integers(0, 2, (B, N, Fn)).astype(np.float32))
    edges = torch.from_numpy(
        rng.integers(0, 2, (B, N, N, E)).astype(np.float32))
    zeros = torch.zeros(B, dtype=torch.long)
    return RoundState(nodes, edges, zeros, zeros, torch.zeros(B, 2),
                      torch.zeros(B, 2, dtype=torch.long),
                      zeros.bool(), zeros.bool())


def test_call_hooks_runs_them_as_a_forward_call_does():
    """Every hook in order, kwargs hooks with an empty dict, on copies of
    the state's input; a returned value is seen by the hooks after it and
    ends in the float32 logits the rest of the round reads."""
    cfg, model = _model()
    st = _state(cfg)
    logits = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, cfg.dim_apd)).astype(np.float32)).to(torch.bfloat16)
    logits32 = logits.float()
    seen = []

    def first(m, args, out):
        seen.append(("first", args[0], args[1], out))
        return out * 2

    def with_kwargs(m, args, kwargs, out):
        seen.append(("kwargs", kwargs, out))

    def last(m, args, out):
        seen.append(("last", out))
        return out.double() + 1           # another dtype: the eager round
    handles = [model.register_forward_hook(first),
               model.register_forward_hook(with_kwargs, with_kwargs=True),
               model.register_forward_hook(last)]
    try:
        rg._call_hooks(model, st, logits, logits32)
    finally:
        for h in handles:
            h.remove()
    assert [s[0] for s in seen] == ["first", "kwargs", "last"]
    _, nodes, edges, out = seen[0]
    assert torch.equal(nodes, st.nodes) and nodes is not st.nodes
    assert torch.equal(edges, st.edges) and edges is not st.edges
    assert torch.equal(out, logits) and out is not logits
    assert seen[1][1] == {} and torch.equal(seen[1][2], logits * 2)
    assert torch.equal(seen[2][1], logits * 2)
    # reads .float() of what the hooks return, as the eager loop
    assert torch.equal(logits32, ((logits * 2).double() + 1).float())


def test_call_hooks_leaves_the_logits_without_a_returned_value():
    cfg, model = _model()
    st = _state(cfg)
    logits = torch.ones(3, cfg.dim_apd, dtype=torch.bfloat16)
    logits32 = torch.full((3, cfg.dim_apd), 7.0)
    handle = model.register_forward_hook(lambda m, a, o: o.add_(1))
    try:
        rg._call_hooks(model, st, logits, logits32)
    finally:
        handle.remove()
    # the hook's in-place edit met a copy, and it returned the copy itself
    assert torch.equal(logits, torch.ones_like(logits))
    assert torch.equal(logits32, torch.full_like(logits32, 2.0))


def test_call_hooks_refuses_what_is_not_logits():
    cfg, model = _model()
    st = _state(cfg)
    logits = torch.ones(3, cfg.dim_apd)
    handle = model.register_forward_hook(lambda m, a, o: o[:, :2])
    try:
        with pytest.raises(TypeError, match="shape"):
            rg._call_hooks(model, st, logits, logits.clone())
    finally:
        handle.remove()


# --------------------------------------------------------------------------
# launch crediting (models/fused_enn.py)
# --------------------------------------------------------------------------

def test_counts_since_and_plus_are_inverse_and_pure():
    """``launch_counts(since=...)`` gives what moved, ``credit_launches``
    adds it back, and neither edits what it was given."""
    saved = fused_enn.launch_counts()
    try:
        fused_enn.reset_launch_counts()
        fused_enn.credit_launches(({"fused_stacked_mlp": 3, "fused_mlp": 7},
                                   {(3, 100, 100): 3, (1, 100, 45): 7},
                                   {((3, 100, 100), 13000): 3,
                                    ((1, 100, 45), 13000): 7}))
        before = fused_enn.launch_counts()
        round_ = ({"fused_stacked_mlp": 3, "fused_mlp": 7},
                  {(3, 100, 100): 3, (1, 100, 45): 2, (1, 685, 585): 5},
                  {((3, 100, 100), 13000): 3, ((1, 100, 45), 13000): 2,
                   ((1, 685, 585), 1000): 5})
        frozen = repr(before), repr(round_)
        for _ in range(4):
            fused_enn.credit_launches(round_)
        after = fused_enn.launch_counts()
        assert after[0] == {"fused_stacked_mlp": 15, "fused_mlp": 35}
        assert after[1][(1, 685, 585)] == 20
        assert after[2][((1, 100, 45), 13000)] == 15
        fused_enn.credit_launches(round_)
        assert fused_enn.launch_counts(since=after) == round_
        assert fused_enn.launch_counts(since=fused_enn.launch_counts()) == (
            {}, {}, {})
        assert (repr(before), repr(round_)) == frozen
    finally:
        fused_enn.reset_launch_counts()
        fused_enn.credit_launches(saved)


def test_credit_launches_adds_one_replay_to_the_live_counters():
    saved = fused_enn.launch_counts()
    try:
        fused_enn.reset_launch_counts()
        live = fused_enn.LAUNCHES
        delta = ({"fused_mlp": 2}, {(1, 4, 4): 2}, {((1, 4, 4), 8): 2})
        fused_enn.credit_launches(delta)
        fused_enn.credit_launches(delta)
        assert fused_enn.LAUNCHES is live
        assert fused_enn.LAUNCHES == {"fused_stacked_mlp": 0, "fused_mlp": 4}
        assert fused_enn.LAUNCHES_BY_LAYOUT == {(1, 4, 4): 4}
        assert fused_enn.LAUNCHES_BY_SHAPE == {((1, 4, 4), 8): 4}
        snap = fused_enn.launch_counts()
        with fused_enn.uncounted():            # a capture adds nothing
            fused_enn.credit_launches(delta)
            fused_enn.credit_launches(({}, {(2, 8, 8): 1}, {}))
        assert fused_enn.launch_counts() == snap
        assert fused_enn.LAUNCHES is live
    finally:
        fused_enn.reset_launch_counts()
        fused_enn.credit_launches(saved)


def test_cached_flats_are_the_model_sites_flattened_weights():
    cfg, model = _model()
    assert fused_enn.cached_flats(model) == []
    x = torch.zeros(2, cfg.max_n_nodes, cfg.hidden_node_features)
    with torch.inference_mode():
        fused_enn.fused_stacked_mlp(model.msg_nns, x)
    flats = fused_enn.cached_flats(model)
    assert len(flats) == 1 and flats[0].E == cfg.n_edge_features


# --------------------------------------------------------------------------
# the refresh: fused_enn._cached_flat rewrites its tensors after an edit
# in place, so a captured round keeps reading the model's weights
# --------------------------------------------------------------------------

def _flat_now(model, cfg, dtype):
    x = torch.zeros(2, cfg.max_n_nodes, cfg.hidden_node_features,
                    dtype=dtype)
    with torch.inference_mode():
        return fused_enn.fused_stacked_mlp(model.msg_nns, x), \
            fused_enn.cached_flats(model)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_flat_rewrites_its_tensors_after_an_edit_in_place(dtype):
    """The same tensors (a graph reads them by address), holding what a
    fresh flatten of the edited weights gives, also where the first
    flatten ran under ``inference_mode`` and the edit outside it."""
    cfg, model = _model()
    _, flat = _flat_now(model, cfg, dtype)
    ptrs = [t.data_ptr() for t in flat if isinstance(t, torch.Tensor)]
    with torch.no_grad():
        for p in model.msg_nns.parameters():
            p.mul_(1.5).add_(0.25)
    out, again = _flat_now(model, cfg, dtype)
    assert again is flat
    assert [t.data_ptr() for t in again
            if isinstance(t, torch.Tensor)] == ptrs
    fresh = fused_enn.flatten_weights(
        fused_enn.stacked_layers(list(model.msg_nns)), dtype, CPU)
    for got, want in zip(again, fresh):
        if isinstance(got, torch.Tensor):
            assert torch.equal(got, want)
        else:
            assert got == want
    x = torch.zeros(2, cfg.max_n_nodes, cfg.hidden_node_features,
                    dtype=dtype)
    model.msg_nns.__dict__.pop("_fused_flat")
    with torch.inference_mode():
        assert torch.equal(out, fused_enn.fused_stacked_mlp(model.msg_nns,
                                                            x))


def test_cached_flat_builds_new_tensors_for_a_replaced_parameter():
    cfg, model = _model()
    _, flat = _flat_now(model, cfg, torch.float32)
    lin = model.msg_nns[0].linears[0]
    old = lin.weight                   # alive, so its address is not reused
    lin.weight = torch.nn.Parameter(old.detach() * 2)
    _, again = _flat_now(model, cfg, torch.float32)
    assert again is not flat and again.w.data_ptr() != flat.w.data_ptr()
    assert not torch.equal(again.w, flat.w)
