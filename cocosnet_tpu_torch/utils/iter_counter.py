"""Training progress bookkeeping; the port's copy of
cocosnet_tpu/utils/iter_counter.py.

Covers the role of the reference's epoch/iteration counter
(util/iter_counter.py) with a different design: everything is derived from
one monotone image counter. An epoch is `images_seen // images_per_epoch`;
the periodic events (print / display / save-latest) fire whenever the
counter crosses a multiple of the corresponding frequency, which reproduces
the reference's modulo-window semantics (`total % freq < batchSize`)
without carrying per-event state.

The on-disk resume record (iter.txt: two integer lines, epoch then
images-into-epoch) stays format-compatible with the reference so training
runs can resume across implementations.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from cocosnet_tpu_torch.config import Options


@dataclass(frozen=True)
class StepEvents:
    """What periodic actions the just-finished step triggered."""
    print_losses: bool = False
    display_visuals: bool = False
    save_latest: bool = False


class TrainProgress:
    """Image-counter-driven epoch/iteration tracker with iter.txt resume."""

    def __init__(self, opt: Options, images_per_epoch: int,
                 write_record: bool = True):
        self.write_record = write_record  # False on all ranks but one
        self.batch = opt.batchSize
        self.images_per_epoch = images_per_epoch
        self.final_epoch = opt.niter + opt.niter_decay
        self.print_freq = opt.print_freq
        self.display_freq = opt.display_freq
        self.save_latest_freq = opt.save_latest_freq
        self.save_epoch_freq = opt.save_epoch_freq
        self.record_path = os.path.join(
            opt.checkpoints_dir, opt.name, "iter.txt")

        start_epoch, into_epoch = 1, 0
        if opt.isTrain and opt.continue_train:
            resumed = self._read_record()
            if resumed is None:
                print(f"Could not load iteration record at "
                      f"{self.record_path}. Starting from beginning.")
            else:
                start_epoch, into_epoch = resumed
                print(f"Resuming from epoch {start_epoch} "
                      f"at iteration {into_epoch}")
        self.start_epoch = start_epoch
        self.images_seen = (start_epoch - 1) * images_per_epoch + into_epoch
        self._epoch_images = 0
        self.current_epoch = start_epoch
        self._epoch_t0 = time.time()
        self._step_t0 = time.time()
        self.time_per_img = 0.0

    @property
    def epoch_iter(self) -> int:
        """Images consumed within the current epoch."""
        return self._epoch_images

    @property
    def total_steps_so_far(self) -> int:
        return self.images_seen

    # ------------------------------------------------------------- epochs

    def epochs(self):
        return range(self.start_epoch, self.final_epoch + 1)

    def begin_epoch(self, epoch: int) -> None:
        self.current_epoch = epoch
        self._epoch_t0 = time.time()
        self._step_t0 = time.time()
        # epoch_iter restarts at 0 while the total keeps any mid-epoch
        # resume offset — the reference's record_epoch_start zeroes
        # epoch_iter but leaves total_steps_so_far (which seeds the
        # print/display/save modulo windows) untouched
        # (util/iter_counter.py:29-40)
        self._epoch_images = 0

    def end_epoch(self) -> None:
        dt = time.time() - self._epoch_t0
        print(f"End of epoch {self.current_epoch} / {self.final_epoch} "
              f"\t Time Taken: {dt:.0f} sec")
        if self.current_epoch % self.save_epoch_freq == 0:
            self._write_record(self.current_epoch + 1, 0)

    # -------------------------------------------------------------- steps

    def _crossed(self, freq: int) -> bool:
        if freq <= 0:
            return False
        return (self.images_seen // freq) > \
            ((self.images_seen - self.batch) // freq)

    def step(self) -> StepEvents:
        """Advance by one batch; report which periodic events fired."""
        now = time.time()
        self.time_per_img = (now - self._step_t0) / max(self.batch, 1)
        self._step_t0 = now
        self.images_seen += self.batch
        self._epoch_images += self.batch
        return StepEvents(
            print_losses=self._crossed(self.print_freq),
            display_visuals=self._crossed(self.display_freq),
            save_latest=self._crossed(self.save_latest_freq),
        )

    # ------------------------------------------------------------- record

    def _read_record(self):
        try:
            with open(self.record_path) as f:
                values = [int(float(line)) for line in f if line.strip()]
            return values[0], values[1]
        except (OSError, ValueError, IndexError):
            return None

    def _write_record(self, epoch: int, into_epoch: int) -> None:
        if not self.write_record:
            return
        try:
            with open(self.record_path, "w") as f:
                f.write(f"{epoch}\n{into_epoch}\n")
            print(f"Saved current iteration count at {self.record_path}.")
        except OSError as err:
            print(err)

    def save_record(self) -> None:
        """Persist the exact mid-epoch position (called with save-latest)."""
        self._write_record(self.current_epoch, self.epoch_iter)

