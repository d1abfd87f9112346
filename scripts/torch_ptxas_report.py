#!/usr/bin/env python3
"""Registers, stack and spills of every CUDA kernel of flow_tpu_torch.

    python3 scripts/torch_ptxas_report.py [--sass] [NAME ...]

Compiles each flow_tpu_torch/csrc/<NAME>.cu (default: all of them) with the
port's own nvcc command plus `-Xptxas -v`, all sources at once, into a
temporary directory, and prints one line per kernel
instantiation: its registers, stack frame and spill bytes. --sass adds a
line per kernel with its instruction mix from `cuobjdump -sass`: the count
of each opcode (without its modifiers) in the compiled code, the most
frequent first, and of the instructions that take an operand from the
constant bank (`c[...]`). Needs nvcc (the machine with the card); imports
neither jax nor flow_tpu.
"""
import collections
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from flow_tpu_torch import _build  # noqa: E402


def _demangle(symbol):
    """'void (anonymous namespace)::k<3, 4>(float const*, ...)' -> 'k<3, 4>'."""
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True, text=True)
    except OSError:
        return symbol
    name = out.stdout.strip().replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ").split("(")[0]
    return name or symbol


def sass_mix(lib):
    """{kernel: (Counter of opcodes, instructions reading the constant bank)}
    of a built library, from cuobjdump -sass."""
    cuobjdump = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    mix, kernel = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            kernel = _demangle(m.group(1))
            mix[kernel] = (collections.Counter(), [0])
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([^;]*);", line)
        if m and kernel:
            mix[kernel][0][m.group(1)] += 1
            if "c[0x" in m.group(2):
                mix[kernel][1][0] += 1
    return {k: (counts, const[0]) for k, (counts, const) in mix.items()}


def report(names, sass=False):
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for name in names:
            cmd = _build.nvcc_command(nvcc, _build.CSRC_DIR / f"{name}.cu",
                                      Path(tmp) / f"lib{name}.so")
            cmd[1:1] = ["-Xptxas", "-v"]
            procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
        failed = False
        for name, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(f"{name}: nvcc failed (exit {proc.returncode})\n{log}")
                failed = True
                continue
            kernel = None
            for line in log.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    kernel = _demangle(m.group(1))
                    stack = stores = loads = "?"
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", line)
                if m:
                    stack, stores, loads = m.groups()
                m = re.search(r"Used (\d+) registers", line)
                if m and kernel:
                    print(f"{name}: {kernel}: {m.group(1)} registers, stack {stack} B, "
                          f"spill stores {stores} B, spill loads {loads} B")
                    kernel = None
            if sass:
                for kernel, (counts, const) in sass_mix(Path(tmp) / f"lib{name}.so").items():
                    top = ", ".join(f"{op} {n}" for op, n in counts.most_common(14))
                    print(f"{name}: {kernel}: {sum(counts.values())} instructions, "
                          f"{const} with a constant-bank operand; {top}")
        return 1 if failed else 0


if __name__ == "__main__":
    args = sys.argv[1:]
    names = ([a for a in args if not a.startswith("-")]
             or sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu")))
    sys.exit(report(names, sass="--sass" in args))
