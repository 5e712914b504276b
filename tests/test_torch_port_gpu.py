"""The hand-written CUDA kernel against its plain version, on the card.

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere.  Imports no JAX, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Tolerances: f32 1e-4 (summation order over K <= 685 in f32); bf16 1/64
absolute plus 1/64 relative, about two bf16 ulps at |y| ~ 1 (the two
versions sum in another order and may round one layer's value to the
neighbouring bf16 number).
"""

import numpy as np
import pytest
import torch

from graphinvent_tpu_torch.models import fused_enn
from graphinvent_tpu_torch.models.core import MLP

TOL = {torch.float32: 1e-4, torch.bfloat16: 1.0 / 64}

# (name, E, rows, I, hidden, O): the GGNN generate job's launch shapes at
# preset("GGNN"), B=1000, N=13, plus a ragged row count, the ChEMBL-width
# message stack (N=40, four bond types) and a row count below one tile
SHAPES = [
    ("msg_nns", 3, 13000, 100, [250] * 4, 100),
    ("att_nn", 1, 13000, 108, [250] * 4, 100),
    ("emb_nn", 1, 13000, 100, [250] * 4, 100),
    ("f_add_1", 1, 13000, 100, [500] * 4, 45),
    ("f_conn_1", 1, 13000, 100, [500] * 4, 3),
    ("f_add_2", 1, 1000, 685, [500] * 4, 585),
    ("f_conn_2", 1, 1000, 139, [500] * 4, 39),
    ("f_term_2", 1, 1000, 100, [500] * 4, 1),
    ("msg_ragged", 3, 12345, 100, [250] * 4, 100),
    ("msg_chembl", 4, 40000, 100, [250] * 4, 100),
    ("f_add_1_r37", 1, 37, 100, [500] * 4, 45),
]


def _plans(shape):
    """bf16 runs every shape under both kinds of plan (no cluster, the
    plan's largest cluster); f32 has one kernel and no plan."""
    dims = (shape[3], *shape[4], shape[5])
    plans = fused_enn.plan_choices(dims)
    if shape[0] == "f_add_2":           # the largest cluster the kernel takes
        plans.append(fused_enn.LaunchPlan(64, 8))
    return plans


CASES = [(s, torch.float32, None) for s in SHAPES] + [
    (s, torch.bfloat16, p) for s in SHAPES for p in _plans(s)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _towers(E, I, hidden, O, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.nn.ModuleList(MLP(I, hidden, O, generator=g)
                               for _ in range(E))


def _case_id(case):
    shape, dtype, plan = case
    if plan is None:
        return f"{shape[0]}-f32"
    return f"{shape[0]}-bf16-tm{plan.tile_rows}-c{plan.cluster}"


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_kernel_matches_plain(cuda, case):
    (name, E, R, I, hidden, O), dtype, plan = case
    towers = _towers(E, I, hidden, O, seed=len(name)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(R, I)).astype(np.float32) * 0.5).to(cuda, dtype)
    flat = fused_enn.flatten_weights(
        fused_enn.stacked_layers(list(towers)), dtype, cuda)
    got = fused_enn.fused_enn_cuda(flat, x, plan)
    ref = fused_enn.fused_stacked_mlp_reference(flat, x)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (E, R, O)
    err = (got.float() - ref.float()).abs().max().item()
    print(f"{_case_id(case)}: max|d| {err:.3g}", flush=True)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
def test_dispatch_counts_launches_and_takes_any_lead_dims(cuda):
    towers = _towers(1, 60, [120] * 2, 30, seed=3).to(cuda)
    fused_enn.reset_launch_counts()
    with torch.inference_mode():
        for shape in ((7, 13, 60), (91, 60)):
            x = torch.randn(*shape, device=cuda)
            got = fused_enn.fused_mlp(towers[0], x)
            flat = fused_enn.flatten_weights(
                fused_enn.stacked_layers([towers[0]]), x.dtype, cuda)
            ref = fused_enn.fused_stacked_mlp_reference(
                flat, x.reshape(-1, 60)).reshape(*shape[:-1], 30)
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    assert fused_enn.LAUNCHES["fused_mlp"] == 2
    assert fused_enn.LAUNCHES_BY_LAYOUT == {(1, 60, 120, 120, 30): 2}


@pytest.mark.gpu
def test_launch_refuses_bad_inputs(cuda):
    towers = _towers(2, 16, [32], 8, seed=1).to(cuda)
    flat = fused_enn.flatten_weights(
        fused_enn.stacked_layers(list(towers)), torch.float32, cuda)
    with pytest.raises(ValueError):
        fused_enn.fused_enn_cuda(flat, torch.randn(4, 17, device=cuda))
    with pytest.raises(TypeError):
        fused_enn.fused_enn_cuda(
            flat, torch.randn(4, 16, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        fused_enn.fused_enn_cuda(flat, torch.randn(4, 16))
    bf16 = fused_enn.flatten_weights(
        fused_enn.stacked_layers(list(towers)), torch.bfloat16, cuda)
    x = torch.randn(4, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):           # 128-row tiles take no cluster
        fused_enn.fused_enn_cuda(bf16, x, fused_enn.LaunchPlan(128, 8))
