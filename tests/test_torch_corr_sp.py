"""The port's spatial-parallel correlation (ops/corr_sp.attend_sp) in gloo
worker processes on the CPU, against the JAX package's attend_sp on the
8-virtual-device mesh and against the port's single-process attend_shift9
and attend_unfold.

Meshes: model 2, model 4, and data 2 x model 2 (the batch shared over the
data ranks). Routes: match_kernel 3 on the shift9 core (its plain versions
here, the kernels' route), match_kernel 3 on the streaming unfold
(use_pallas off), match_kernel 1 with PONO_C (the unfold at k = 1). Each
worker computes the whole output on every rank of its model group and the
gradients of sum(sin(out)) to the whole maps; every rank of a model group
must hold the same output and gradients.

Tolerances: the output at 2e-5 against JAX where tests/test_corr_sp.py
holds its SP form to 2e-5 (and 1e-3 on the data x model mesh, where it
holds 1e-3); gradients at atol = rtol = 2e-3 (its bound,
tests/test_corr_sp.py:180); against the port's single-process result,
2e-5 on the output and 2e-4 on the gradients (tests/test_torch_shift9_
grad.py's bound between two f32 orders of the same function: here the
model group's all_reduce sums the gradient shares in another order). JAX
runs attend_unfold_sp on the CPU for every route (its fused form is the
TPU's), the same function the port's routes compute.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cocosnet_tpu import mesh as JM
from cocosnet_tpu.ops.corr_sp import attend_sp as j_attend_sp
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import mesh as M
from cocosnet_tpu_torch.models.correspondence import CorrespondenceNet
from cocosnet_tpu_torch.ops import corr_sp as SP
from cocosnet_tpu_torch.ops.corr_shift import attend_unfold
from cocosnet_tpu_torch.ops.shift9 import attend_shift9
from test_torch_threads import torch_threads  # noqa: F401
from torch_fixtures import condition, sp_worker, spawn_job

TAU = 0.01
B, H, W, C, D = 2, 8, 8, 8, 3
ROUTES = {"shift9": dict(mk=3, use_pallas=True),
          "unfold": dict(mk=3, use_pallas=False),
          "mk1": dict(mk=1, use_pallas=True)}
MESHES = {"model2": (1, 2), "model4": (1, 4), "data2_model2": (2, 2)}


def _maps(seed=0):
    rs = np.random.RandomState(seed)
    f = rs.randn(B, H, W, C).astype(np.float32)
    g = (rs.randn(B, H, W, C) * 1.5 + 0.2).astype(np.float32)
    v = rs.randn(B, H * W, D).astype(np.float32)
    return f, g, v


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """{mesh: {route: [(out, grads) of each rank]}} from one job per mesh."""
    f, g, v = (torch.from_numpy(a) for a in _maps())
    cases = {r: dict(f=f, g=g, v=v, tau=TAU, **kw) for r, kw in ROUTES.items()}
    runs = {}
    for name, (data, model) in MESHES.items():
        tmp = tmp_path_factory.mktemp(name)
        torch.save(cases, tmp / "cases.pt")
        spawn_job(sp_worker, data * model, tmp, data, model,
                  str(tmp / "cases.pt"), str(tmp))
        ranks = [torch.load(tmp / f"rank{r}.pt")
                 for r in range(data * model)]
        runs[name] = {r: [res[r] for res in ranks] for r in ROUTES}
    return runs


def _whole(per_rank, data, model):
    """The global batch's output and gradients from the ranks of model
    index 0, in data-rank order."""
    firsts = [per_rank[d * model] for d in range(data)]
    out = torch.cat([o for o, _ in firsts])
    grads = [torch.cat([gr[i] for _, gr in firsts]) for i in range(3)]
    return out.numpy(), [t.numpy() for t in grads]


def _jax(mesh, route):
    data, model = MESHES[mesh]
    jmesh = jax.sharding.Mesh(
        np.asarray(jax.devices()[:data * model]).reshape(data, model),
        ("data", "model"))
    kw = ROUTES[route]

    def fn(f, g, v):
        return j_attend_sp(f, g, v, TAU, mesh=jmesh, match_kernel=kw["mk"],
                           pono_c=True, use_pallas=kw["use_pallas"])

    @jax.jit
    def out_and_grads(f, g, v):
        out, vjp = jax.vjp(fn, f, g, v)
        return out, vjp(jnp.cos(out))

    out, grads = out_and_grads(*(jnp.asarray(a) for a in _maps()))
    return np.asarray(out), [np.asarray(t) for t in grads]


def _single(route):
    """The port's single-process result and gradients."""
    kw = ROUTES[route]
    leaves = [torch.from_numpy(a).requires_grad_() for a in _maps()]
    if kw["mk"] == 3 and kw["use_pallas"]:
        out = attend_shift9(*leaves, TAU, True)
    else:
        out = attend_unfold(*leaves, TAU, kw["mk"], True)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("mesh", MESHES)
def test_sp_matches_jax_attend_sp(sp_runs, mesh, route):
    data, model = MESHES[mesh]
    out, grads = _whole(sp_runs[mesh][route], data, model)
    want, wgrads = _jax(mesh, route)
    tol = 1e-3 if data > 1 else 2e-5
    np.testing.assert_allclose(out, want, atol=tol,
                               rtol=1e-3 if data > 1 else 1e-5)
    for name, a, b in zip("fgv", grads, wgrads):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=2e-3,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("mesh", MESHES)
def test_sp_matches_single_process(sp_runs, mesh, route):
    """The same function as the port's single-process route, and every
    rank of a model group holds the same output and gradients."""
    data, model = MESHES[mesh]
    per_rank = sp_runs[mesh][route]
    out, grads = _whole(per_rank, data, model)
    want, wgrads = _single(route)
    np.testing.assert_allclose(out, want, atol=2e-5)
    for name, a, b in zip("fgv", grads, wgrads):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4,
                                   err_msg=f"d{name}")
    for d in range(data):
        first = per_rank[d * model]
        for k in range(1, model):
            other = per_rank[d * model + k]
            assert torch.equal(other[0], first[0])
            for a, b in zip(other[1], first[1]):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_sp_refuses_what_jax_refuses():
    """Spatial centering has no SP form, and H must divide the model
    group, as in the JAX package (both checked before any collective)."""
    f, g, v = (torch.from_numpy(a) for a in _maps())
    with pytest.raises(NotImplementedError, match="PONO_C"):
        SP.attend_sp(f, g, v, TAU, mesh=M.Mesh(1, 2, 0), pono_c=False)
    with pytest.raises(ValueError, match="must divide the model axis 3"):
        SP.attend_sp(f, g, v, TAU, mesh=M.Mesh(1, 3, 0))
    with pytest.raises(ValueError, match="registered mesh has 1"):
        SP.attend_sp(f, g, v, TAU, model=2)
    for fn in (SP.attend_shift9_sp, SP.attend_unfold_sp):
        with pytest.raises(NotImplementedError, match="PONO_C"):
            fn(f, g, v, TAU, slice(0, W), pono_c=False)
    with pytest.raises(ValueError, match="whole image rows"):
        SP.attend_shift9_sp(f, g, v, TAU, slice(1, W + 1))
    # JAX refuses the same flags
    jf, jg, jv = (jnp.asarray(a) for a in _maps())
    with pytest.raises(NotImplementedError, match="PONO_C"):
        j_attend_sp(jf, jg, jv, TAU, mesh=JM.create_mesh(1, 2), pono_c=False)


def test_one_rank_model_group_runs_without_collectives():
    """A mesh whose model axis has one rank runs the shard of all rows:
    the single-process result, no process group needed."""
    f, g, v = (torch.from_numpy(a) for a in _maps())
    for route, kw in ROUTES.items():
        got = SP.attend_sp(f, g, v, TAU, mesh=M.Mesh(1, 1, 0),
                           match_kernel=kw["mk"], use_pallas=kw["use_pallas"])
        np.testing.assert_allclose(got.detach().numpy(), _single(route)[0],
                                   atol=2e-5, err_msg=route)


def test_mk1_without_pono_c_warns_and_runs_replicated():
    """--mesh_model > 1 at match_kernel 1 without PONO_C warns and runs the
    dense path on every rank, as models/correspondence.py:287-301 of the
    JAX package does (no collective: it runs in this one process)."""
    opt = TCFG.test_defaults(
        dataset_mode="ade20k", label_nc=5, contain_dontcare_label=True,
        crop_size=32, load_size=32, ngf=8, PONO=True, PONO_C=False,
        match_kernel=1, mesh_model=2, use_attention=False, maskmix=True,
        warp_mask_losstype="direct", isTrain=False)
    net = CorrespondenceNet(opt).eval()
    condition(net, 0)
    rs = np.random.RandomState(1)
    ref = torch.from_numpy(rs.randn(1, 32, 32, 3).astype(np.float32))
    seg = torch.nn.functional.one_hot(
        torch.from_numpy(rs.randint(0, opt.semantic_nc, (1, 32, 32))),
        opt.semantic_nc).float()
    with pytest.warns(UserWarning, match="REPLICATED"):
        out = net(ref, seg, seg)
    assert torch.isfinite(out["warp_out"]).all()
