"""The port's fused ENN kernel, through its plain version on the CPU,
against the JAX package's Pallas kernel in interpret mode; and the
dispatch rules around it.

Tolerances: f32 rtol=atol=2e-5, the JAX package's own bar for its kernel
(tests/test_models.py::test_fused_enn_matches_stacked).  bf16: 1/64
absolute plus 1/64 relative, about one bf16 ulp at |y| in [1, 4): both
sum the same exact bf16 products in f32, in another order, and may round
a layer's value to the neighbouring bf16 number; and the port's error
against the f32 result may exceed the JAX kernel's by at most one ulp of
the largest output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphinvent_tpu.models.core import init_mlp, init_stacked_mlp
from graphinvent_tpu.models import fused_enn as jax_fused

from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.models import fused_enn
from graphinvent_tpu_torch.models.core import MLP, stacked_mlp

from _torch_port_util import mlp_from_jax, seeded, to_np, towers_from_jax

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = 1.0 / 64


def _compare(got, ref, truth, ref_dtype):
    """got/ref in the compute dtype, truth the f32 result."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    if ref_dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
        return
    np.testing.assert_allclose(got, ref, rtol=BF16_TOL, atol=BF16_TOL)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(truth).max())) - 7)
    port_err = np.abs(got - truth).max()
    jax_err = np.abs(ref - truth).max()
    assert port_err <= jax_err + ulp, (port_err, jax_err, ulp)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("E", [1, 3, 4])
def test_stacked_plain_matches_pallas_interpret(E, dt):
    jdt, tdt = DTYPES[dt]
    params = init_stacked_mlp(jax.random.PRNGKey(E), E, 100, [250] * 2, 100)
    x = seeded((7, 13, 100), seed=E)           # 91 rows: 91 % 64 != 0
    ref = jax_fused.fused_stacked_mlp(params, jnp.asarray(x, jdt), tile=64,
                                      interpret=True)
    truth = jax_fused.fused_stacked_mlp(params, jnp.asarray(x), tile=64,
                                        interpret=True)
    towers = towers_from_jax(params)
    with torch.inference_mode():
        got = fused_enn.fused_stacked_mlp(towers, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == (E, 7, 13, 100)
    _compare(to_np(got), ref, np.asarray(truth), dt)


MLP_CASES = {
    "2d": ((91, 60), 60, [120] * 2, 30),
    "3d": ((7, 13, 60), 60, [120] * 2, 30),
    "O=1": ((13, 100), 100, [96] * 2, 1),
    "K=685": ((9, 685), 685, [64] * 2, 585),
}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_plain_matches_pallas_interpret(case, dt):
    jdt, tdt = DTYPES[dt]
    shape, I, hidden, O = MLP_CASES[case]
    params = init_mlp(jax.random.PRNGKey(len(case)), I, hidden, O)
    x = seeded(shape, seed=len(shape))
    ref = jax_fused.fused_mlp(params, jnp.asarray(x, jdt), tile=64,
                              interpret=True)
    truth = jax_fused.fused_mlp(params, jnp.asarray(x), tile=64,
                                interpret=True)
    with torch.inference_mode():
        got = fused_enn.fused_mlp(mlp_from_jax(params),
                                  torch.from_numpy(x).to(tdt))
    assert got.shape == shape[:-1] + (O,)
    _compare(to_np(got), ref, np.asarray(truth), dt)


def _towers(E=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.nn.ModuleList(MLP(16, [24], 8, generator=g)
                               for _ in range(E))


def test_flat_weights_cached_per_model_and_rebuilt_on_change():
    towers = _towers()
    x = torch.randn(2, 5, 16)
    with torch.inference_mode():
        fused_enn.fused_stacked_mlp(towers, x)
        first = towers.__dict__["_fused_flat"][1]
        fused_enn.fused_stacked_mlp(towers, x)
        assert towers.__dict__["_fused_flat"][1] is first
    key = towers.__dict__["_fused_flat"][0]
    w = first.w.clone()
    with torch.no_grad():
        towers[1].linears[0].weight.add_(1.0)
    with torch.inference_mode():
        out = fused_enn.fused_stacked_mlp(towers, x)
    # rebuilt into the same tensors (a captured CUDA graph reads them)
    assert towers.__dict__["_fused_flat"][0] != key
    assert towers.__dict__["_fused_flat"][1] is first
    assert not torch.equal(first.w, w)
    torch.testing.assert_close(out, stacked_mlp(list(towers), x).detach(),
                               rtol=1e-5, atol=1e-5)


def test_flat_layout_pads_to_16_and_keeps_true_widths():
    towers = _towers(E=2)
    flat = fused_enn.flatten_weights(fused_enn.stacked_layers(list(towers)),
                                     torch.bfloat16, torch.device("cpu"))
    assert flat.dims == (16, 24, 8) and flat.layout == (2, 16, 24, 8)
    assert flat.w.numel() == 2 * (16 * 32 + 32 * 16)
    assert flat.b.dtype == torch.float32 and flat.b.numel() == 2 * (32 + 16)
    # the wgmma image pads K and O to 64: two 64 x 64 tiles per tower
    assert flat.slabs.dtype == torch.bfloat16
    assert flat.slabs.numel() == 2 * (64 * 64 + 64 * 64)
    f32 = fused_enn.flatten_weights(fused_enn.stacked_layers(list(towers)),
                                    torch.float32, torch.device("cpu"))
    assert f32.slabs is None
    w0, b0 = next(fused_enn._layer_views(flat))
    ref = towers[1].linears[0].weight.t().to(torch.bfloat16)
    assert torch.equal(w0[1], ref)
    assert torch.equal(b0[1], towers[1].linears[0].bias.to(torch.bfloat16)
                       .float())


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    fused_enn.reset_launch_counts()
    with torch.inference_mode():
        fused_enn.fused_mlp(_towers(E=1)[0], torch.randn(4, 16))
    assert fused_enn.LAUNCHES == {"fused_stacked_mlp": 0, "fused_mlp": 0}
    assert fused_enn.LAUNCHES_BY_LAYOUT == {}


def test_other_devices_raise():
    with torch.inference_mode(), pytest.raises(RuntimeError):
        fused_enn.fused_mlp(_towers(E=1)[0].to("meta"),
                            torch.randn(4, 16, device="meta"))


def test_cuda_launch_refuses_cpu_tensors():
    towers = _towers()
    flat = fused_enn.flatten_weights(fused_enn.stacked_layers(list(towers)),
                                     torch.float32, torch.device("cpu"))
    with pytest.raises(ValueError):
        fused_enn.fused_enn_cuda(flat, torch.randn(4, 16))


def test_gate_follows_config_train_and_autograd():
    cfg = port_tiny("GGNN", device="cpu")
    with torch.no_grad():
        assert fused_enn.fused_gate(cfg, train=False)
        assert not fused_enn.fused_gate(cfg, train=True)
        assert not fused_enn.fused_gate(
            cfg.replace(fused_inference_enn=False), train=False)
    with torch.inference_mode():
        assert fused_enn.fused_gate(cfg, train=False)
    assert not fused_enn.fused_gate(cfg, train=False)     # grad enabled


def test_model_forward_routes_by_gate(monkeypatch):
    """Grad-free forwards reach the fused wrappers (7 readout + 1 stacked
    call per pass); grad-enabled ones take core.stacked_mlp / core.mlp."""
    from graphinvent_tpu_torch.models import build_model
    cfg = port_tiny("GGNN", device="cpu")
    model = build_model(cfg, torch.Generator().manual_seed(0))
    calls = []
    real_stacked, real_mlp = fused_enn.fused_stacked_mlp, fused_enn.fused_mlp
    monkeypatch.setattr(
        "graphinvent_tpu_torch.models.mpnn.fused_stacked_mlp",
        lambda *a: calls.append("stacked") or real_stacked(*a))
    monkeypatch.setattr(
        fused_enn, "fused_mlp",
        lambda *a: calls.append("mlp") or real_mlp(*a))
    nodes = torch.zeros(2, cfg.max_n_nodes, cfg.n_node_features)
    edges = torch.zeros(2, cfg.max_n_nodes, cfg.max_n_nodes,
                        cfg.n_edge_features)
    with torch.inference_mode():
        fused = model(nodes, edges)
    assert calls.count("stacked") == cfg.message_passes
    assert calls.count("mlp") == 7
    calls.clear()
    unfused = model(nodes, edges)
    assert calls == []
    torch.testing.assert_close(fused, unfused.detach(), rtol=1e-5, atol=1e-5)


def _unswizzle(image, E, K, O):
    """Reads the slab image back element by element with numpy index
    arithmetic (independent of the port's torch gather): returns (E, O64,
    K64) with [e, o, k] the weight of input k in output o."""
    K64, O64 = -(-K // 64) * 64, -(-O // 64) * 64
    nk, nch = K64 // 64, O64 // 64
    flat = np.asarray(image.float())
    idx = np.arange(flat.size)
    within, rest = idx % 8, idx // 8
    phys, rest = rest % 8, rest // 8
    n, rest = rest % 64, rest // 64
    ch, rest = rest % nch, rest // nch
    ks, e = rest % nk, rest // nk
    k = ks * 64 + (phys ^ (n % 8)) * 8 + within
    o = ch * 64 + n
    out = np.full((E, O64, K64), np.nan, np.float32)
    out[e, o, k] = flat
    return out


@pytest.mark.parametrize("O", [1, 45, 585])
@pytest.mark.parametrize("K", [100, 685])
@pytest.mark.parametrize("E", [1, 3])
def test_slab_image_unswizzles_to_padded_weights(E, K, O):
    w = torch.from_numpy(seeded((E, O, K), seed=K + O))
    image = fused_enn.slab_image(w, torch.bfloat16)
    K64, O64 = -(-K // 64) * 64, -(-O // 64) * 64
    assert image.numel() == E * O64 * K64
    ref = np.zeros((E, O64, K64), np.float32)
    ref[:, :O, :K] = to_np(w.to(torch.bfloat16))
    np.testing.assert_array_equal(_unswizzle(image, E, K, O), ref)


def _preset_sites():
    """(name, R, E, dims) of the GGNN generate job's launches, B=1000."""
    from test_torch_port_gpu import SHAPES
    return {s[0]: (s[2], s[1], (s[3], *s[4], s[5])) for s in SHAPES}


@pytest.mark.parametrize("site", ["f_add_2", "f_conn_2", "f_term_2"])
def test_launch_plan_clusters_the_1000_row_heads(site):
    """16 row tiles of 64: a cluster of 4 gives 64 blocks, all resident at
    once; 8 would give 128 blocks in two waves on the H100 (PERF.md)."""
    R, E, dims = _preset_sites()[site]
    plan = fused_enn.launch_plan(R, E, dims)
    assert plan == fused_enn.LaunchPlan(64, fused_enn.MAX_CLUSTER)
    assert fused_enn.MAX_CLUSTER == 4
    assert -(-R // 64) * E * plan.cluster == 64


@pytest.mark.parametrize("site", ["msg_nns", "att_nn", "emb_nn", "f_add_1",
                                  "f_conn_1"])
def test_launch_plan_fills_the_card_without_cluster_at_13000_rows(site):
    R, E, dims = _preset_sites()[site]
    plan = fused_enn.launch_plan(R, E, dims)
    assert plan.cluster == 1
    assert -(-R // plan.tile_rows) * E >= fused_enn.MIN_BLOCKS
    # the 250-wide stacks fit 128-row tiles, the 500-wide heads do not
    assert plan.tile_rows == (128 if max(dims) < 500 else 64)


def test_launch_plan_is_deterministic_and_fits_shared_memory():
    for name, (R, E, dims) in _preset_sites().items():
        plan = fused_enn.launch_plan(R, E, dims)
        assert plan == fused_enn.launch_plan(R, E, dims), name
        for p in [plan, *fused_enn.plan_choices(dims)]:
            smem, stages = fused_enn.smem_plan(dims, p)
            assert smem <= fused_enn.MAX_SMEM, (name, p)
            assert 2 <= stages <= fused_enn.MAX_STAGES, (name, p)


def _n40_sites():
    """(R, E, dims) of every launch of a GGNN forward at ChEMBL-proxy
    width (N=40, aromatic bonds: E=4), B=1000."""
    from graphinvent_tpu_torch.config import preset
    cfg = preset("GGNN", max_n_nodes=40, use_aromatic_bonds=True)
    R, B, H, G = 1000 * 40, 1000, cfg.hidden_node_features, cfg.gather_width
    h1, h2 = [cfg.mlp1_hidden_dim] * 4, [cfg.mlp2_hidden_dim] * 4
    fa, fc = cfg.len_f_add_per_node, cfg.len_f_conn_per_node
    return {
        "msg_nns": (R, cfg.n_edge_features, (H, *[250] * 4, H)),
        "att_nn": (R, 1, (H + cfg.n_node_features, *[250] * 4, G)),
        "emb_nn": (R, 1, (H, *[250] * 4, G)),
        "f_add_1": (R, 1, (H, *h1, fa)),
        "f_conn_1": (R, 1, (H, *h1, fc)),
        "f_add_2": (B, 1, (40 * fa + G, *h2, 40 * fa)),
        "f_conn_2": (B, 1, (40 * fc + G, *h2, 40 * fc)),
        "f_term_2": (B, 1, (G, *h2, 1)),
    }


@pytest.mark.parametrize("site", list(_n40_sites()))
def test_every_n40_site_fits_and_only_f_add_2_streams_its_input(site):
    """f_add_2's input at N=40 (40 x 60 + 100 = 2,500 columns, 320 KB for
    64 rows) does not fit in shared memory beside the ring: layer 0
    streams it by K-slab; every other site keeps its whole input tile."""
    R, E, dims = _n40_sites()[site]
    plan = fused_enn.launch_plan(R, E, dims)
    for p in [plan, *fused_enn.plan_choices(dims)]:
        smem, stages = fused_enn.smem_plan(dims, p)
        assert smem <= fused_enn.MAX_SMEM and 2 <= stages, (site, p)
        streams = fused_enn._smem_plan(dims, p, False) is None
        assert streams == (site == "f_add_2"), (site, p)
    assert (dims[0] == 2500) == (site == "f_add_2")


def test_swizzle_is_its_own_inverse():
    t = torch.arange(2 * 64 * 64, dtype=torch.float32).reshape(2, 64, 64)
    s = fused_enn.swizzle_tiles(t)
    assert not torch.equal(s, t)
    assert torch.equal(fused_enn.swizzle_tiles(s), t)
    # row n keeps its 16-byte groups XOR-permuted by n % 8
    assert torch.equal(s[0, 3, 8:16], t[0, 3, 16:24])
