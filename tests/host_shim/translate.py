"""Compile a CUDA source of the port as host C++ against cuda_shim.h.

    python tests/host_shim/translate.py OUT.so SRC.cu [SRC.cu ...]

`translate` rewrites what no macro can: each `kernel<<<grid, block, smem,
stream>>>(args);` becomes `shim::launch(kernel, grid, block, smem, args);`,
`extern __shared__ T name[];` a pointer to the block's dynamic arena, and
each static `__shared__` variable a pointer (or reference) into the block's
static arena, so that the blocks of a cluster, which run at the same time,
each have their own.  The CUDA includes are dropped.  `build` compiles the
result with g++ -std=c++20 into a shared library with the source's own C
entry points, which take host pointers.

It handles the constructs of csrc/kmer_funnel.cu and csrc/resolve_pack.cu
(tests/test_torch_host_shim.py runs both against their plain versions);
cuda_shim.h says what such a run can and cannot show.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SHIM = os.path.join(HERE, "cuda_shim.h")


def _split_args(s: str) -> list[str]:
    """Split at the commas that are outside every bracket."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur).strip())
    return parts


def translate(src: str) -> str:
    src = re.sub(r'#include <(cuda_runtime|cooperative_groups)\.h>\n', "", src)

    def launch(m):
        cfg = _split_args(m.group(2))
        if len(cfg) != 4:
            raise ValueError(f"launch of {m.group(1)}: expected <<<grid, block, smem, stream>>>")
        grid, block, smem, _stream = cfg
        return f"shim::launch({m.group(1)}, dim3({grid}), dim3({block}), {smem}, {m.group(3)});"

    src = re.sub(r"(\w+)<<<(.*?)>>>\(\s*(.*?)\);", launch, src, flags=re.S)
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(shim::dyn_smem());", src)
    n = [0]

    def key() -> int:
        n[0] += 1
        return n[0]

    def shared(m):
        typ, decls = m.group(1), _split_args(m.group(2))
        out = []
        for d in decls:
            arr = re.fullmatch(r"(\w+)\[(.+)\]", d)
            if arr:
                out.append(f"{typ}* {arr.group(1)} = shim::static_smem<{typ}>({key()}, {arr.group(2)});")
            else:
                out.append(f"{typ}& {d} = *shim::static_smem<{typ}>({key()}, 1);")
        return " ".join(out)

    src = re.sub(r"__shared__ ([\w ]+?) (\w+(?:\[[^;]*\])?(?:, \w+(?:\[[^;]*\])?)*);", shared, src)
    if "__shared__" in src or "<<<" in src:
        raise ValueError("a __shared__ declaration or a launch was not translated")
    return src


def build(out_so: str, sources: list[str]) -> None:
    """g++ the translated sources into `out_so`; raises with g++'s output."""
    with tempfile.TemporaryDirectory() as tmp:
        cpps = []
        for s in sources:
            cpp = os.path.join(tmp, os.path.basename(s)[:-3] + ".cpp")
            with open(s) as f, open(cpp, "w") as g:
                g.write(translate(f.read()))
            cpps.append(cpp)
        cmd = ["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-include", SHIM,
               *cpps, "-o", out_so]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")


if __name__ == "__main__":
    build(sys.argv[1], sys.argv[2:])
