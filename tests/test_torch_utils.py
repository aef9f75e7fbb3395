"""The port's utils against the JAX package's: the visual grids and label
colours (the same PNG bytes), the training progress bookkeeping (the same
events and the same iter.txt, across a save and a resume in either
package), the loss log line, and the profiling hooks (torch.profiler in
place of jax.profiler: a Chrome trace of the block on the CPU)."""

import json
import os

import numpy as np
import pytest
import torch

from cocosnet_tpu import config as JCFG
from cocosnet_tpu.utils import iter_counter as JIC
from cocosnet_tpu.utils import logging as JLOG
from cocosnet_tpu.utils import visuals as JV
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch.utils import iter_counter as TIC
from cocosnet_tpu_torch.utils import logging as TLOG
from cocosnet_tpu_torch.utils import profiling as TPR
from cocosnet_tpu_torch.utils import visuals as TV
from test_torch_threads import torch_threads  # noqa: F401


def test_label_colours_match_jax():
    rs = np.random.RandomState(0)
    labels = rs.randint(0, 152, (2, 1, 9, 7))
    assert np.array_equal(TV.masktorgb(labels), JV.masktorgb(labels))
    assert np.array_equal(TV.labelcolormap(40), JV.labelcolormap(40))
    onehot = rs.rand(2, 5, 6, 12).astype(np.float32)
    assert np.array_equal(TV.tensor2label(onehot, 12),
                          JV.tensor2label(onehot, 12))
    img = rs.rand(2, 5, 6, 3).astype(np.float32) * 2.4 - 1.2
    assert np.array_equal(TV.tensor2im(img), JV.tensor2im(img))


@pytest.mark.parametrize("n,nrow", [(6, 2), (7, 3)])
def test_grids_match_jax(tmp_path, n, nrow):
    imgs = np.random.RandomState(n).rand(n, 8, 5, 3).astype(np.float32)
    TV.save_image_grid(imgs, str(tmp_path / "t" / "g.png"), nrow=nrow)
    JV.save_image_grid(imgs, str(tmp_path / "j" / "g.png"), nrow=nrow)
    TV.save_image(imgs[0], str(tmp_path / "t" / "i.png"))
    JV.save_image(imgs[0], str(tmp_path / "j" / "i.png"))
    for f in ("g.png", "i.png"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()


def _progress(mod, cfg, tmp_path, **kw):
    opt = cfg.test_defaults(isTrain=True, batchSize=4, niter=2,
                            niter_decay=1, checkpoints_dir=str(tmp_path),
                            name="prog", print_freq=12, display_freq=8,
                            save_latest_freq=20, save_epoch_freq=2, **kw)
    return mod.TrainProgress(opt, images_per_epoch=40)


def _walk(p, steps):
    events = []
    for epoch in p.epochs():
        p.begin_epoch(epoch)
        for _ in range(steps):
            ev = p.step()
            events.append((epoch, p.epoch_iter, p.images_seen,
                           ev.print_losses, ev.display_visuals,
                           ev.save_latest))
            if ev.save_latest:
                p.save_record()
        p.end_epoch(**({"verbose": True} if isinstance(
            p, JIC.TrainProgress) else {}))
    return events


@pytest.mark.parametrize("resumer", ["jax", "port"])
def test_train_progress_matches_jax(tmp_path, resumer):
    """The events of three epochs, the iter.txt each writes, and a resume
    from the other package's record."""
    os.makedirs(tmp_path / "t" / "prog")
    os.makedirs(tmp_path / "j" / "prog")
    got = _walk(_progress(TIC, TCFG, tmp_path / "t"), 10)
    want = _walk(_progress(JIC, JCFG, tmp_path / "j"), 10)
    assert got == want
    assert (tmp_path / "t" / "prog" / "iter.txt").read_text() == \
        (tmp_path / "j" / "prog" / "iter.txt").read_text()
    # a mid-epoch record, read back by the other package
    with open(tmp_path / "t" / "prog" / "iter.txt", "w") as f:
        f.write("2\n12\n")
    mod, cfg = (JIC, JCFG) if resumer == "jax" else (TIC, TCFG)
    q = _progress(mod, cfg, tmp_path / "t", continue_train=True)
    assert (q.start_epoch, q.images_seen) == (2, 52)


def test_loss_log_matches_jax(tmp_path):
    errors = {"GAN": torch.tensor(1.23456), "D_real": 0.5, "img/s": 12.0}
    kw = dict(name="log")
    TLOG.print_current_errors(TCFG.test_defaults(
        checkpoints_dir=str(tmp_path / "t"), **kw), 2, 16, errors, 0.125)
    JLOG.print_current_errors(JCFG.test_defaults(
        checkpoints_dir=str(tmp_path / "j"), **kw), 2, 16,
        {k: float(v) for k, v in errors.items()}, 0.125)
    got = (tmp_path / "t" / "log" / "loss_log.txt").read_text()
    assert got == (tmp_path / "j" / "log" / "loss_log.txt").read_text()
    assert got == ("(epoch: 2, iters: 16, time: 0.125) GAN: 1.235 "
                   "D_real: 0.500 img/s: 12.000 \n")


def test_maybe_trace_writes_a_chrome_trace(tmp_path):
    with TPR.maybe_trace(str(tmp_path), enabled=False):
        torch.ones(3).sum()
    assert not os.listdir(tmp_path)
    with TPR.maybe_trace(str(tmp_path), name="step"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "step.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
