"""--steps_per_dispatch on the CPU: the port's make_multi_train_step, its
train twin loop and its data-parallel chunk, at tests/test_torch_train.py's
size (crop 64, ngf 8, ndf 8, label_nc 5, batch 2, f32).

- The port's chunk of K = 2 on two different batches against JAX
  make_multi_train_step (one lax.scan, compiled once through
  torch_fixtures.jit_quick) from the same weights: the losses of step 0 at
  rel 2e-3 and of step 1 at 2e-2 (|t| + 1e-2 below), as
  tests/test_torch_train.py holds two JAX steps; after the chunk the EMA
  shadows' moves at 10% relative L2 (that file's bound for one step), each
  network's parameter move at 10% a step, K x 10% (the chunk's move is the
  sum of its steps' moves, each held to 10%; measured up to 12% for G),
  and the spectral u/v at atol 2e-4: that file's 2e-5 after one step,
  grown 10x for the second as its loss bounds grow (2e-3 -> 2e-2; measured
  4.1e-5 after the chunk).
- The chunk against K single port steps from the same weights: every loss
  and every tensor of the state bit for bit.
- The train twin with --steps_per_dispatch on a synthetic ADE20k tree of 8
  photos (4 steps an epoch at batch 2): with K = 3 the loss lines of K =
  1, a `latest` save due inside the chunk made at its end with iter.txt
  counting that end, the tail step alone; checkpoints of either value
  resume under the other; --D_steps_per_G 2 prints train.py's message and
  runs a step at a time.
- The chunk over two gloo data ranks against one process at batch 2: the
  losses at the bounds above, every rank's parameters the same bits and
  the one process's at tests/test_torch_parallel_train.py's rtol 2e-2 /
  atol 5e-4.
"""

import copy
import os
import re
import shutil
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cocosnet_tpu import config as JCFG
from cocosnet_tpu import pix2pix as JP
from cocosnet_tpu.train import state as JS
from cocosnet_tpu.train import steps as JST
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import mesh as M
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.cli import train as TTRAIN
from cocosnet_tpu_torch.convert import (ema_from_flax, flax_path,
                                        load_flax_variables)
from cocosnet_tpu_torch.data import synthetic as SYN
from cocosnet_tpu_torch.nn import layers as TL
from cocosnet_tpu_torch.train import state as TS
from cocosnet_tpu_torch.train import steps as TST
from cocosnet_tpu_torch.utils.iter_counter import TrainProgress
from test_torch_threads import torch_threads  # noqa: F401
from test_torch_train import (LOSS_KEYS, OPT, _batch, _jnp, _spectral,
                              _variables)
from torch_fixtures import chunk_worker, jit_quick, parallel_chunk, spawn_job

K = 2
TOLS = (2e-3, 2e-2)


def _rel(got, want):
    return abs(got - want) / (abs(want) + 1e-2)


def _port_run(variables):
    """Port nets on the CPU holding `variables`, and their train state."""
    tnets = TP.Pix2PixNets(TCFG.test_defaults(**OPT), device="cpu")
    for name in ("gen", "corr", "disc", "vgg"):
        load_flax_variables(getattr(tnets, name), variables[name])
    return tnets, TS.create_train_state(tnets.opt, tnets)


def _state(nets, state) -> dict:
    out = {f"{n}.{k}": v.clone() for n in ("gen", "corr", "disc")
           for k, v in getattr(nets, n).state_dict().items()}
    out.update({f"ema.{k}": v.clone() for k, v in state.ema.items()})
    for side in ("opt_g", "opt_d"):
        for i, st in getattr(state, side).state_dict()["state"].items():
            out.update({f"{side}.{i}.{k}": torch.as_tensor(v).clone()
                        for k, v in st.items()})
    return out


@pytest.fixture(scope="module")
def chunks():
    """JAX's chunk of K on two batches (its losses (K,) and state after),
    the port's chunk from the same weights (losses, state, nets, the
    parameters before), and K single port steps from them (losses,
    state)."""
    jopt = JCFG.test_defaults(**OPT)
    jnets = JP.Pix2PixNets(jopt)
    variables = _variables(jnets, jopt)
    batches = [_batch(0), _batch(1)]
    lr = JS.lrs_for_epoch(jopt, 1)
    stacked = {k: jnp.stack([jnp.asarray(b[k]) for b in batches])
               for k in batches[0]}
    jstate = JS.create_train_state(jopt, _jnp(variables),
                                   jax.random.PRNGKey(1))
    args = (jstate, stacked, jnp.asarray(lr))
    jstate, jmetrics, _ = jit_quick(JST.make_multi_train_step(jnets),
                                    *args)(*args)
    jlosses = {k: np.asarray(v) for k, v in jmetrics.items()}
    jstate = jax.tree.map(np.asarray, jstate)

    tnets, tstate = _port_run(variables)
    p0 = {f"{n}.{k}": p.detach().clone() for n in ("gen", "corr", "disc")
          for k, p in getattr(tnets, n).named_parameters()}
    losses, visuals = TST.make_multi_train_step(tnets)(tstate, batches, lr)
    snets, sstate = _port_run(variables)
    step = TST.make_train_step(snets)
    single = [step(sstate, b, lr)[0] for b in batches]
    return dict(jlosses=jlosses, jstate=jstate, losses=losses,
                visuals=visuals, nets=tnets, state=tstate, p0=p0,
                single=single, single_state=_state(snets, sstate),
                single_step=sstate.step)


@pytest.mark.parametrize("key", LOSS_KEYS)
@pytest.mark.parametrize("step", range(K))
def test_chunk_losses_match_jax(chunks, key, step):
    assert set(chunks["losses"]) == set(chunks["jlosses"]) == set(LOSS_KEYS)
    got = chunks["losses"][key]
    assert got.shape == (K,)
    t, o = float(chunks["jlosses"][key][step]), float(got[step])
    assert np.isfinite(o)
    assert _rel(o, t) < TOLS[step], (key, step, t, o)


@pytest.mark.parametrize("net", ["gen", "corr", "disc"])
def test_chunk_state_matches_jax(chunks, net):
    """After the chunk: every spectral u/v at atol 2e-4 (G's and Corr's
    advanced twice, D's four times), and the network's parameter move p_K
    - p0 at K x 10% relative L2 of JAX's (the module docstring says
    why)."""
    jvars = chunks["jstate"].variables[net]
    want = _spectral(jvars["spectral"])
    sd = getattr(chunks["nets"], net).state_dict()
    names = [k for k in sd if k.endswith(("weight_u", "weight_v"))]
    assert len(names) == len(want) > 0
    for name in names:
        _, path, _ = flax_path(name, 1)
        np.testing.assert_allclose(sd[name].numpy(), want[path], atol=2e-4)
    num = den = 0.0
    for name, p in getattr(chunks["nets"], net).named_parameters():
        collection, path, kind = flax_path(name, p.dim())
        w = jvars[collection]
        for key in path:
            w = w[key]
        if kind == "hwio":
            w = np.transpose(w, (3, 2, 0, 1))
        w = np.asarray(w).reshape(tuple(p.shape)).astype(np.float64)
        p0 = chunks["p0"][f"{net}.{name}"].double().numpy()
        num += float(((p.detach().double().numpy() - w) ** 2).sum())
        den += float(((w - p0) ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 0.1 * K, (num / den) ** 0.5


def test_chunk_ema_matches_jax(chunks):
    """The EMA shadows' moves over the chunk at 10% relative L2 of
    JAX's."""
    tnets = chunks["nets"]
    want = ema_from_flax(TS.g_named_parameters(tnets), chunks["jstate"].ema)
    num = den = 0.0
    for k, v in chunks["state"].ema.items():
        p0 = chunks["p0"][k].double().numpy()
        ref = want[k].double().numpy()
        num += float(((v.double().numpy() - ref) ** 2).sum())
        den += float(((ref - p0) ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 0.1, (num / den) ** 0.5


def test_chunk_equals_single_steps(chunks):
    """The chunk is K single steps, bit for bit: losses, every net's
    parameters and buffers, the EMA, both Adam states; the step counter
    and the last step's visuals."""
    for j, single in enumerate(chunks["single"]):
        for k, v in single.items():
            assert torch.equal(chunks["losses"][k][j], v), (j, k)
    got = _state(chunks["nets"], chunks["state"])
    assert got.keys() == chunks["single_state"].keys()
    for k, v in chunks["single_state"].items():
        assert torch.equal(got[k], v), k
    assert chunks["state"].step == chunks["single_step"] == K
    assert chunks["visuals"]["fake_image"].shape == (2, 64, 64, 3)


# ------------------------------------------------------------- the twin

@pytest.fixture(autouse=True)
def _port_policy():
    """The twins set the port's process-wide conv policy; restore it."""
    prev = TL.get_compute_dtype()
    yield
    TL.set_compute_dtype(prev)


@pytest.fixture(scope="module")
def tree():
    base = tempfile.mkdtemp(prefix="tmulti_")
    root = os.path.join(base, "ade")
    SYN.make_ade20k_tree(root, n_train=8, n_val=1, size=(80, 72),
                         n_classes=13, block=8)
    yield base, root
    shutil.rmtree(base, ignore_errors=True)


def _twin_flags(base, root, name, *extra):
    return ["--dataset_mode", "ade20k", "--dataroot", root, "--label_nc",
            "12", "--batchSize", "2", "--crop_size", "64", "--load_size",
            "72", "--ngf", "8", "--ndf", "8", "--use_attention", "--maskmix",
            "--warp_mask_losstype", "direct", "--PONO", "--PONO_C",
            "--compute_dtype", "f32", "--nThreads", "2", "--platform", "cpu",
            "--weight_mask", "100.0", "--use_ema", "--vgg_normal_correct",
            "--niter", "1", "--niter_decay", "0", "--save_epoch_freq", "1",
            "--print_freq", "2", "--display_freq", "100",
            "--save_latest_freq", "2", "--checkpoints_dir",
            os.path.join(base, "ck"), "--output_dir",
            os.path.join(base, "out"), "--name", name, *extra]


def _loss_lines(base, name):
    """The loss log's lines without their times and rates."""
    with open(os.path.join(base, "ck", name, "loss_log.txt")) as f:
        lines = [ln for ln in f if ln.startswith("(epoch")]
    return [re.sub(r"time: \S+\) |img/s: \S+ ", "", ln) for ln in lines]


@pytest.fixture(scope="module")
def twins(tree):
    """Runs of the train twin: "one" at K = 1, "three" at K = 3 (4 steps:
    a chunk and a tail step), each resumed for a second epoch under the
    other value; what each save and iter.txt record held, by run name; the
    sizes of the chunks each first run took."""
    base, root = tree
    events = []
    save_state = TTRAIN.C.save_state
    save_record = TrainProgress.save_record
    make_multi = TST.make_multi_train_step
    sizes = []

    def spy_save(opt, state, nets, label):
        events.append((opt.name, "save", label, state.step))
        return save_state(opt, state, nets, label)

    def spy_record(self):
        events.append((os.path.basename(os.path.dirname(self.record_path)),
                       "iter.txt", self.current_epoch, self.epoch_iter))
        return save_record(self)

    def spy_multi(nets):
        multi = make_multi(nets)

        def run(state, batches, lr):
            sizes.append(len(batches))
            return multi(state, batches, lr)
        return run

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TTRAIN.C, "save_state", spy_save)
        mp.setattr(TrainProgress, "save_record", spy_record)
        mp.setattr(TST, "make_multi_train_step", spy_multi)
        for name, k in (("one", "1"), ("three", "3")):
            runs[name] = TTRAIN.main(_twin_flags(base, root, name,
                                                 "--steps_per_dispatch", k))
            runs[name + " sizes"] = list(sizes)
            sizes.clear()
        # each checkpoint resumes under the other value
        for name, k in (("one", "3"), ("three", "1")):
            runs[name + " resumed"] = TTRAIN.main(_twin_flags(
                base, root, name, "--steps_per_dispatch", k,
                "--continue_train", "--niter", "2"))
    return runs, events


def test_twin_chunk_prints_the_single_steps_lines(tree, twins):
    """K = 3 prints K = 1's loss lines, in both epochs (the second resumed
    under the other value)."""
    base, _ = tree
    runs, _ = twins
    one, three = _loss_lines(base, "one"), _loss_lines(base, "three")
    assert len(one) == 8
    assert one == three
    assert runs["one"].g_steps == runs["three"].g_steps == 4
    assert len(runs["three"].step_seconds) == 4
    assert runs["one"].losses == runs["three"].losses


def test_twin_chunk_runs_a_chunk_and_its_tail(twins):
    """K = 3 over 4 steps: one chunk of 3 through make_multi_train_step,
    the last step alone; K = 1 takes no chunk."""
    runs, _ = twins
    assert runs["three sizes"] == [3]
    assert runs["one sizes"] == []


def test_twin_saves_latest_at_the_chunk_boundary(twins):
    """--save_latest_freq 2 asks for `latest` after every step: at K = 1
    after each, at K = 3 once after the chunk (step 3, iter.txt at 6
    images), then after the tail step."""
    _, events = twins

    def of(name):
        out = [e[1:] for e in events if e[0] == name]
        return out[:out.index(("save", "1", 4)) - 1]   # epoch 1's steps

    assert of("one") == [x for s in range(1, 5) for x in (
        ("save", "latest", s), ("iter.txt", 1, 2 * s))]
    assert of("three") == [("save", "latest", 3), ("iter.txt", 1, 6),
                           ("save", "latest", 4), ("iter.txt", 1, 8)]


def test_twin_checkpoints_resume_across_the_flag(tree, twins):
    """A K = 1 checkpoint resumes under K = 3 and the other way round: the
    step counter and iter.txt carry on, and the epoch runs its 4 steps."""
    base, _ = tree
    runs, _ = twins
    for name in ("one", "three"):
        run = runs[name + " resumed"]
        assert run.state.step == 8 and run.g_steps == 4
        with open(os.path.join(base, "ck", name, "iter.txt")) as f:
            assert f.read().split() == ["3", "0"]
        assert all(np.isfinite(v) for v in run.losses.values())


def test_twin_d_steps_per_g_runs_a_step_at_a_time(tree, capsys):
    base, root = tree
    run = TTRAIN.main(_twin_flags(base, root, "d2", "--steps_per_dispatch",
                                  "2", "--D_steps_per_G", "2"))
    out = capsys.readouterr().out
    assert ("steps_per_dispatch > 1 is unsupported with D_steps_per_G > 1;"
            " running per-step dispatch") in out
    assert (run.g_steps, run.d_steps) == (2, 2)


# ------------------------------------------------------ data parallelism

def test_chunk_over_two_data_ranks(tmp_path):
    """A chunk of K over two gloo data ranks (each its shard of the global
    batch of 2; self_ref [1, 0]) against one process: each step's losses
    at TOLS, the ranks' parameters the same bits, and the one process's at
    rtol 2e-2 / atol 5e-4. The CPU runs the eager chunk; on the card the
    same gloo job would refuse to capture it (mesh.check_capturable)."""
    opt = TCFG.test_defaults(**dict(OPT, weight_mask=50.0))
    batches = [_batch(0), _batch(1)]
    for b in batches:
        b["self_ref"] = np.asarray([1.0, 0.0], np.float32)
    M.set_global_mesh(None)
    one = parallel_chunk(opt, batches)
    spawn_job(chunk_worker, 2, tmp_path, 2, 1, opt.replace(mesh_data=2),
              batches, str(tmp_path))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    M.check_capturable()     # one process: nothing to refuse
    for rank in ranks:
        assert "gloo job's collectives cannot be captured" in rank["refused"]
        for key, want in one["losses"].items():
            for j in range(K):
                assert _rel(float(rank["losses"][key][j]),
                            float(want[j])) <= TOLS[j], (key, j)
    for net, params in ranks[0]["params"].items():
        for name, p in params.items():
            assert torch.equal(ranks[1]["params"][net][name], p)
            np.testing.assert_allclose(p.numpy(),
                                       one["params"][net][name].numpy(),
                                       rtol=2e-2, atol=5e-4,
                                       err_msg=f"{net}.{name}")


# ------------------------------------------------------------ checkpoints

def test_optimizer_state_loads_into_either_kind_of_adam():
    """train.state.load_optimizer: a card run's Adam state (capturable, its
    rate a 0-d tensor) loads into the CPU's Adam as a float rate, not
    capturable, its step counts on the host, and steps; a CPU run's loads
    into a capturable Adam, whose rate tensor takes the saved value in
    place and whose step counts follow the parameters."""
    w = torch.nn.Parameter(torch.ones(3))
    cpu = torch.optim.Adam([w], lr=1e-3)
    w.grad = torch.full((3,), 0.5)
    cpu.step()
    saved = copy.deepcopy(cpu.state_dict())
    card_form = {"state": copy.deepcopy(saved["state"]),
                 "param_groups": [dict(saved["param_groups"][0],
                                       lr=torch.tensor(2e-3),
                                       capturable=True)]}
    v = torch.nn.Parameter(torch.ones(3))
    fresh = torch.optim.Adam([v], lr=1e-4)
    TS.load_optimizer(fresh, card_form)
    group = fresh.param_groups[0]
    assert group["lr"] == pytest.approx(2e-3)
    assert isinstance(group["lr"], float) and not group["capturable"]
    assert fresh.state[v]["step"].device.type == "cpu"
    v.grad = torch.full((3,), 0.5)
    fresh.step()
    assert float(fresh.state[v]["step"]) == 2.0
    rate = torch.tensor(1e-4)
    capt = torch.optim.Adam([torch.nn.Parameter(torch.ones(3))], lr=rate,
                            capturable=True)
    TS.load_optimizer(capt, saved)
    group = capt.param_groups[0]
    assert group["lr"] is rate and float(rate) == pytest.approx(1e-3)
    assert group["capturable"]
    st = next(iter(capt.state.values()))
    assert st["step"].dtype == torch.float32 and float(st["step"]) == 1.0
