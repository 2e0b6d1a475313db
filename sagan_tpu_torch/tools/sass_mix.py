"""The instruction mix of a kernel's innermost tensor-core loop, read from
the SASS that ``cuobjdump -sass`` prints for a library of the port.

    python -m sagan_tpu_torch.tools.sass_mix \\
        [--kernel attention_flash_dqkv_mma_kernel] [--d 2] [--c 8] [-D ...]

Builds ``csrc/attention_flash_mma.cu`` at value width ``c`` with the
given ``-D`` defines (none: the shipped library), disassembles it, takes
the kernel ``kernel`` instantiated at head width ``d``, finds its loops
(a backward branch and the instructions between its target and itself)
and prints, for the shortest loop that holds an ``HMMA``, its length and
its instructions counted by opcode, then one JSON object of them.  For
K6 that loop is one 16-query step over the warp's key tiles, so its
counts over the key tiles a warp owns are the mix of one key tile.
Needs the CUDA toolkit (``nvcc`` and ``cuobjdump``); no card.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
from pathlib import Path

from ..ops import _build
from ..ops import cuda_attention as ca

_INSTRUCTION = re.compile(
    r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)(.*?);")


def cuobjdump() -> str:
    """Path of ``cuobjdump``: on PATH, else beside ``nvcc``."""
    found = shutil.which("cuobjdump")
    return found or str(Path(_build.nvcc()).with_name("cuobjdump"))


def functions(sass: str) -> dict:
    """{mangled name: its SASS text} of every function in ``sass``."""
    parts = sass.split("Function : ")[1:]
    return {part.split("\n", 1)[0].strip(): part for part in parts}


def loops(text: str) -> list:
    """[(first address, last address, [(address, opcode)])] of every loop
    in one function's SASS: a branch back to an earlier address and the
    instructions from that address to the branch."""
    ins = [(int(m.group(1), 16), m.group(2), m.group(3))
           for m in map(_INSTRUCTION.match, text.splitlines()) if m]
    found = []
    for addr, op, rest in ins:
        target = re.search(r"0x([0-9a-f]+)", rest)
        lo = int(target.group(1), 16) if target else addr
        if op.startswith("BRA") and lo < addr:
            found.append((lo, addr, [(a, o) for a, o, _ in ins
                                     if lo <= a <= addr]))
    return found


def inner_mix(text: str) -> dict:
    """The shortest loop of ``text`` that holds an HMMA: its address
    range, length and opcodes counted (base opcode, and in full), and the
    length of the shortest loop around it (null if none)."""
    mma = [loop for loop in loops(text)
           if any(op.startswith("HMMA") for _, op in loop[2])]
    if not mma:
        raise ValueError("no loop holds an HMMA")
    lo, hi, body = min(mma, key=lambda loop: len(loop[2]))
    around = [len(b) for a, z, b in mma if a <= lo and hi <= z
              and len(b) > len(body)]
    return {"range": [hex(lo), hex(hi)], "instructions": len(body),
            "around": min(around, default=None),
            "by_opcode": dict(collections.Counter(
                op.split(".")[0] for _, op in body).most_common()),
            "in_full": dict(collections.Counter(
                op for _, op in body).most_common())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="attention_flash_dqkv_mma_kernel")
    ap.add_argument("--d", type=int, default=2)
    ap.add_argument("--c", type=int, default=8)
    ap.add_argument("-D", dest="defines", action="append", default=[],
                    metavar="NAME=VALUE", help="a define of the build")
    args = ap.parse_args(argv)
    tiles = tuple(f"-D{d}" for d in args.defines)
    spec = ca.build_specs((args.c,), (ca.MMA_SOURCE,), tiles)[0]
    path = _build.build([spec])[spec]
    sass = subprocess.run([cuobjdump(), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    tag = f"{args.kernel}ILi{args.d}ELi{args.c}E"
    name, text = next((n, t) for n, t in functions(sass).items()
                      if tag in n)
    mix = inner_mix(text)
    result = {"kernel": name, "defines": list(tiles), **mix}
    print(f"{args.kernel} d={args.d} c={args.c} {list(tiles) or 'shipped'}: "
          f"innermost HMMA loop {mix['range']}, {mix['instructions']} "
          f"instructions (the loop around it {mix['around']}): "
          f"{mix['by_opcode']}", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
