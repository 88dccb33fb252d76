#!/usr/bin/env python3
"""Compare the SASS of the port's CUDA kernels between two checkouts, on
a machine with ``nvcc``.

    python3 scripts/compare_torch_sass.py OTHER_ROOT SOURCE [SOURCE ...]

Builds ``pigeon_tpu_torch/csrc/<SOURCE>.cu`` in this checkout and in
``OTHER_ROOT`` (each with its own `native.build_cuda`), disassembles both
with ``cuobjdump -sass`` and pairs their kernels by name and first
template argument (the tag type), so that a kernel whose template or
parameter list grew is still paired. Prints one line a kernel: its
instruction count on each side and how many instructions differ once
addresses and encodings are stripped (0: the same code), and how many
once registers are renamed away too. Exits 1 if a kernel is unpaired or
differs.
"""

from __future__ import annotations

import difflib
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(root: str, source: str) -> str:
    """Path of ``source``'s library built in the checkout ``root``."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from pigeon_tpu_torch import native; "
            "print(native.build_cuda(sys.argv[2]).path)")
    return subprocess.run([sys.executable, "-c", code, root, source],
                          cwd=root, capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]


def stable(mangled: str) -> str:
    """``mangled`` with the hashes in its anonymous namespace's name
    (``_GLOBAL__N__<hash>_<file>_<hash>``, which differ from build to
    build) zeroed and its length kept, so that a kernel whose name cu++filt
    leaves mangled pairs across checkouts all the same."""
    found = re.search(r"(\d+)(_GLOBAL__N__)", mangled)
    if not found:
        return mangled
    start = found.start(2)
    end = start + int(found.group(1))
    part = re.sub(r"(?<=_)[0-9a-f]{8}(?=_|$)", "0" * 8, mangled[start:end])
    return mangled[:start] + part + mangled[end:]


def kernels(lib: str, tools: str) -> dict:
    """``{name<tag: [instruction, ...]}`` of a library's SASS."""
    sass = subprocess.run([os.path.join(tools, "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True,
                          check=True).stdout.splitlines()
    out, key = {}, None
    for line in sass:
        if "Function :" in line:
            mangled = stable(line.split("Function :", 1)[1].strip())
            name = subprocess.run([os.path.join(tools, "cu++filt"), mangled],
                                  capture_output=True, text=True,
                                  check=True).stdout.strip()
            name = re.sub(r"\(anonymous namespace\)::|<unnamed>::|"
                          r"\{anonymous\}::", "", name)
            found = (re.search(r"(\w+)<(\w+)", name)
                     or re.search(r"(\w+)\(", name))
            key = found.group(0).rstrip("(") if found else mangled
            out[key] = []
        elif key and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            ins = re.sub(r"/\*.*?\*/", "", line).strip().rstrip(";").strip()
            if ins:
                out[key].append(ins)
    return out


def differ(a: list, b: list) -> int:
    """Instructions of ``a`` and ``b`` outside their longest common
    runs (difflib), so one moved instruction counts once or twice."""
    matched = sum(m.size for m in difflib.SequenceMatcher(
        None, a, b, autojunk=False).get_matching_blocks())
    return len(a) + len(b) - 2 * matched


def opcodes(a: list) -> list:
    """The instructions with their registers renamed away."""
    return [re.sub(r"\bU?[RP]\d+\b|\bUP\d\b", "R", ins) for ins in a]


def main(argv: list) -> int:
    if len(argv) < 2:
        raise SystemExit(__doc__.splitlines()[2].strip())
    other, sources = os.path.abspath(argv[0]), argv[1:]
    sys.path.insert(0, HERE)
    from pigeon_tpu_torch import native

    tools = os.path.dirname(native.nvcc())
    bad = 0
    for source in sources:
        here = kernels(build(HERE, source), tools)
        there = kernels(build(other, source), tools)
        for key in sorted(set(here) | set(there)):
            a, b = here.get(key), there.get(key)
            if a is None or b is None:
                bad += 1
                side = "this checkout" if b is None else other
                print(f"{source} {key}: only in {side}")
                continue
            diff = differ(a, b)
            bad += diff > 0
            print(f"{source} {key}: {len(a)} instructions here, {len(b)} "
                  f"there, {diff} differ, {differ(opcodes(a), opcodes(b))} "
                  f"with registers renamed away")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
