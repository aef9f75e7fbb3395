"""Registers and spills of the kernels of csrc/, as ptxas reports them.

Compiles each source with the port's nvcc flags plus `-Xptxas -v` into
build/kernels/ptxas/ and prints one line per kernel: registers a thread,
bytes of spill stores and loads, and the kernel's name (demangled where
the toolkit's cu++filt is there). Needs nvcc, so it runs on the machine
with the card; from the repository root:

    python3 -m cocosnet_tpu_torch.tools.ptxas_usage [source ...]

with source names as in ops/_build.SOURCES (default: all of them).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess

from cocosnet_tpu_torch.ops import _build

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def _demangle(names):
    tool = shutil.which("cu++filt") or os.path.join(
        os.path.dirname(_build.nvcc()), "cu++filt")
    if not names or not os.path.exists(tool):
        return names
    out = subprocess.run([tool, *names], capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) \
        else names


def usage(name: str):
    """[(kernel, registers, spill store bytes, spill load bytes)] of
    csrc/<name>.cu."""
    out_dir = os.path.join(_build.BUILD_DIR, "ptxas")
    os.makedirs(out_dir, exist_ok=True)
    cmd = _build._compile_cmd(name, os.path.join(out_dir, name + ".so"))
    log = subprocess.run(cmd[:1] + ["-Xptxas", "-v"] + cmd[1:],
                         capture_output=True, text=True, check=True).stderr
    rows, entry, spill = [], None, (0, 0)
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            entry = m.group(1)
        elif m := _SPILL.search(line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := _REGS.search(line)) and entry is not None:
            rows.append([entry, int(m.group(1)), *spill])
            entry, spill = None, (0, 0)
    for row, nice in zip(rows, _demangle([r[0] for r in rows])):
        row[0] = nice
    return [tuple(r) for r in rows]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", default=list(_build.SOURCES))
    args = ap.parse_args(argv)
    for name in args.sources:
        for kernel, regs, st, ld in usage(name):
            print(f"{name}.cu: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B: {kernel}", flush=True)


if __name__ == "__main__":
    main()
