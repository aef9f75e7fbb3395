"""The port's training trajectory against the JAX package on the CPU at f32:
four fused G + D steps of JAX make_train_step and of the port's
(cocosnet_tpu_torch/tools/parity_trajectory.run_port) at
tools/parity_trajectory.py's setting (`_TRAIN_OVERRIDES`: match_kernel 1,
64 px, batch 2, ngf 64, ndf 16, 12 classes, PONO / PONO_C, EMA, TTUR), from
the same weights on the same `_make_batches` data. The port's nets are drawn
under a seed and conditioned (nn.layers.condition_weights); the JAX side
takes their state dicts through convert_torch_module, as the JAX tool's
run_ours takes the reference's; both share one seeded random VGG19.

The port runs both routes of the correlation: "library" (matmul + softmax
under autograd, JAX's use_pallas=False) and "kernels"
(COCOSNET_PALLAS_MK1_TRAIN=1 with opt.use_pallas True: attend_corr's plain
versions here); the JAX side takes its XLA attend either way, so one JAX
run serves both. Every loss term at every step is one case, held to
tests/test_trajectory_parity.py's schedule: rel 2e-3, 2e-2, 5e-2, 2e-1 at
steps 0-3, |t| + 1e-2 in the denominator (the warp softmax at tau 0.01 is
argmax-like, so drift compounds with the steps). The JAX step compiles once
for the module (torch_fixtures.jit_quick).

The 50-step run is this file's __main__, not a test:
    python tests/test_torch_trajectory.py --steps 50 \\
        --out PARITY_TRAJECTORY_TORCH.json
writes PARITY_TRAJECTORY.json's format with "jax" and "port" in place of
"torch" and "ours" (rel |port - jax| / (|jax| + 1e-3), as there); with
--perturb 1e-7 it holds JAX against JAX from weights perturbed that much
("perturbed" in place of "port"); --perturb_seed S [S ...] draws the
perturbation from each seed in turn (default 1), against one unperturbed
JAX run, and with more than one seed names each run "perturbed_<S>".
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cocosnet_tpu import config as JCFG  # noqa: E402
from cocosnet_tpu import pix2pix as JP  # noqa: E402
from cocosnet_tpu.train import state as JS  # noqa: E402
from cocosnet_tpu.train import steps as JST  # noqa: E402
from cocosnet_tpu.train.checkpoints import (  # noqa: E402
    convert_torch_module, default_name_map)
from cocosnet_tpu_torch.ops import corr as K  # noqa: E402
from cocosnet_tpu_torch.tools import parity_trajectory as PT  # noqa: E402
from test_torch_threads import torch_threads  # noqa: E402,F401
from tools import parity_trajectory as JT  # noqa: E402
from tools.convert_weights import _disc_name_map, merge_into  # noqa: E402
from torch_fixtures import jit_quick  # noqa: E402

STEPS = 4
TOLS = (2e-3, 2e-2, 5e-2, 2e-1)
TERMS = ("no_vgg_feat", "GAN", "GAN_Feat", "fm", "perc", "contextual",
         "mask", "D_Fake", "D_real")


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def run_jax(batches, init_sd, vgg_sd, compile_fn=jit_quick):
    """JAX make_train_step for len(batches) steps from the port's state
    dicts: tools/parity_trajectory.run_ours's lines, compiled by
    compile_fn. Returns {term: [value per step]}."""
    opt = JCFG.test_defaults(
        dataset_mode="ade20k", load_size=64, use_pallas=False,
        **{k: v for k, v in JT._TRAIN_OVERRIDES.items()
           if k not in ("phase", "semantic_nc")})
    nets = JP.Pix2PixNets(opt)
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    variables = nets.init_all(jax.random.PRNGKey(0), b0)
    for name, key, name_map in (("gen", "G", default_name_map),
                                ("corr", "Corr", default_name_map),
                                ("disc", "D", _disc_name_map)):
        variables[name] = merge_into(
            variables[name], convert_torch_module(_np(init_sd[key]),
                                                  name_map))
    variables["vgg"] = merge_into(
        variables["vgg"], convert_torch_module(_np(vgg_sd),
                                               default_name_map))
    state = JS.create_train_state(opt, variables, jax.random.PRNGKey(1))
    lr = jnp.asarray(JS.lrs_for_epoch(opt, 1))
    step = compile_fn(JST.make_train_step(nets), state, b0, lr)
    curves = {}
    for batch in batches:
        state, metrics, _ = step(state, {k: jnp.asarray(v)
                                         for k, v in batch.items()}, lr)
        for k, v in metrics.items():
            curves.setdefault(k, []).append(float(v))
    return curves


@pytest.fixture(scope="module")
def runs():
    """{"jax": curves, route: (curves, attend_corr's plain calls forward
    and backward)} for four steps."""
    batches = PT.make_batches(STEPS)
    init_sd, vgg_sd = PT.make_init_sd(0), PT.make_vgg_sd(7)
    out = {"jax": run_jax(batches, init_sd, vgg_sd)}
    for route in PT.ROUTES:
        before = (K.attend_corr.plain_calls,
                  K.attend_corr_backward.plain_calls)
        curves, _ = PT.run_port(batches, init_sd, vgg_sd, "cpu", route)
        out[route] = (curves, (K.attend_corr.plain_calls - before[0],
                               K.attend_corr_backward.plain_calls
                               - before[1]))
    return out


def test_setting_and_data_are_the_jax_tools():
    """The copies: the overrides, and the batches bit for bit."""
    assert PT._TRAIN_OVERRIDES == JT._TRAIN_OVERRIDES
    for a, b in zip(PT.make_batches(2), JT._make_batches(
            2, b=2, size=64, label_nc=12)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("route", PT.ROUTES)
def test_terms_are_jaxs(runs, route):
    curves, _ = runs[route]
    assert set(curves) == set(runs["jax"]) == set(TERMS)


@pytest.mark.parametrize("route", PT.ROUTES)
@pytest.mark.parametrize("term", TERMS)
@pytest.mark.parametrize("step", range(STEPS))
def test_trajectory_matches_jax(runs, route, term, step):
    t = runs["jax"][term][step]
    o = runs[route][0][term][step]
    assert np.isfinite(o)
    rel = abs(o - t) / (abs(t) + 1e-2)
    assert rel < TOLS[step], (
        f"{route} {term} step {step}: jax {t:.5f} port {o:.5f} rel "
        f"{rel:.4f} (tol {TOLS[step]})\njax:  "
        f"{np.round(runs['jax'][term], 5).tolist()}\nport: "
        f"{np.round(runs[route][0][term], 5).tolist()}")


@pytest.mark.parametrize("route,want", [("library", (0, 0)),
                                        ("kernels", (STEPS, STEPS))])
def test_route_runs_attend_corr_once_a_step(runs, route, want):
    """The kernel route runs attend_corr's forward and backward once a
    step (their plain versions here); the library route neither."""
    assert runs[route][1] == want


def _perturbed(init_sd, eps: float, seed: int = 1):
    """init_sd with every floating tensor of G, Corr and D times (1 + eps
    n), n standard normal from `seed`."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return {key: {k: (v * (1 + eps * torch.randn(v.shape, generator=g))
                      if v.is_floating_point() else v)
                  for k, v in sd.items()}
            for key, sd in init_sd.items()}


def main(argv=None) -> dict:
    """The 50-step comparison of the f32 library route with JAX (jax.jit at
    full optimisation, as run_ours compiles). With --perturb EPS, JAX
    against JAX from the same weights times (1 + EPS n) instead, n drawn
    from each --perturb_seed: the spread the setting's dynamics give a
    difference of that size."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out", default="PARITY_TRAJECTORY_TORCH.json")
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--perturb_seed", type=int, nargs="+", default=[1])
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    batches = PT.make_batches(args.steps)
    init_sd, vgg_sd = PT.make_init_sd(0), PT.make_vgg_sd(7)
    jax_curves = run_jax(batches, init_sd, vgg_sd,
                         lambda fn, *a: jax.jit(fn))
    others = {}
    if args.perturb:
        seeds = args.perturb_seed
        for seed in seeds:
            name = (f"perturbed_{seed}" if len(seeds) > 1 else "perturbed")
            others[name] = run_jax(
                batches, _perturbed(init_sd, args.perturb, seed), vgg_sd,
                lambda fn, *a: jax.jit(fn))
    else:
        others["port"] = PT.run_port(batches, init_sd, vgg_sd, "cpu",
                                     "library")[0]
    report = {}
    for k in sorted(jax_curves):
        t = np.asarray(jax_curves[k])
        report[k] = {"jax": t.tolist()}
        for name, other in others.items():
            o = np.asarray(other[k])
            rel = np.abs(o - t) / (np.abs(t) + 1e-3)
            suffix = "" if len(others) == 1 else f"_{name}"
            report[k].update({name: o.tolist(),
                              "max_rel" + suffix: float(rel.max()),
                              "mean_rel" + suffix: float(rel.mean())})
            print(f"{k:12s} {name} mean_rel={rel.mean():.4f} "
                  f"max_rel={rel.max():.4f} final jax={t[-1]:.4f} "
                  f"{name}={o[-1]:.4f}", flush=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    return report

if __name__ == "__main__":
    main()
