#!/usr/bin/env python3
"""Registers, stack, shared memory and blocks per SM of the port's CUDA
kernels, and the loops of their machine code, on a machine with nvcc.

    PYTHONPATH=<tree> python3 probes/kernel_resources.py --tag NAME
        [--functions SUBSTRING ...] [--sources STEM ...]

Compiles each ``csrc/*.cu`` of the package on ``PYTHONPATH`` (or those
named by ``--sources``, e.g. ``f64_render``) with the package's own nvcc
flags and ``-Xptxas -v`` into an object in a temporary directory, and
reads per kernel what ptxas reports (registers, stack frame, spills,
static shared memory). Blocks per SM follow from the H100's limits
(65,536 registers allocated 256 a warp, 233,472 bytes of shared memory
with 1 KB reserved a block, 2,048 threads, 32 blocks) at each kernel's
block size (the compact kernel's ``kTile``, its pool; else 128) and its
dynamic shared memory at the main path's shapes (the staged scene 1: 512
slots of 44 bytes, with its group table where the kernel stages one, or
of 32 bytes as the f64 kernel's double scan table;
the stream walk's 32 KB of stage). For the kernels whose names contain
one of ``--functions``, ``cuobjdump -sass`` gives the machine code: every
loop (a branch back to an earlier address) is listed with its length in
instructions and its mix of opcodes, and the code goes to
``chiprun_out/sass_<tag>_<kernel>.txt``.
Prints one JSON line and writes it to ``chiprun_out/resources_<tag>.json``.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

REGS_PER_SM = 65536
SMEM_PER_SM = 233472
THREADS = 128  # kBlock (path_common.cuh)
# Dynamic shared memory a block takes on the main path, by kernel name
# prefix: the staged scene 1, and the stream walk's stage where the tree's
# stream kernel launches with one (kStageBytes in its source).
# The kernels that stage scene 1's group table beside it take 34,032 bytes
# (path_common.cuh: staged_bytes(512, false, true)).
TWO_LEVEL = 512 * 44 + 524 * 20 + 64 * 16
DYNAMIC = {"regen_kernel<false>": TWO_LEVEL, "count_kernel<false": TWO_LEVEL,
           "park_render_kernel<false>": TWO_LEVEL,
           "reverse_kernel<false": 512 * 44, "compact_kernel<false>": TWO_LEVEL,
           "f64_kernel<false>": 512 * 32}
STAGE = 32768


def short_name(name: str) -> str:
    """A demangled kernel's name with its template arguments and without
    its return type, namespace and parameter list."""
    if name.endswith(")"):
        depth = 0
        for k in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[k], 0)
            if depth == 0:
                name = name[:k]
                break
    for junk in ("(anonymous namespace)::", "<unnamed>::"):
        name = name.replace(junk, "")
    name = name.replace("(bool)0", "false").replace("(bool)1", "true")
    name = re.sub(r"\(int\)(-?\d+)", r"\1", name)
    return re.sub(r"^void ", "", name).strip()


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool or not names:
        return dict(zip(names, names))
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out))


def blocks_per_sm(regs: int, smem: int, threads: int = THREADS) -> int:
    warps = threads // 32
    per_warp = math.ceil(regs * 32 / 256) * 256
    by_regs = REGS_PER_SM // (per_warp * warps) if regs else 32
    by_smem = SMEM_PER_SM // (smem + 1024)
    return min(32, 2048 // threads, by_regs, by_smem)


def ptxas(text: str) -> dict:
    """Per mangled kernel: registers, stack, spills, static shared memory."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[cur]["static_smem"] = int(s.group(1)) if s else 0
    return out


def sass_functions(text: str) -> dict:
    """Mangled name -> [(address, instruction text)]."""
    funcs: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def opcode(ins: str) -> str:
    ins = re.sub(r"^@!?U?P\w+\s+", "", ins)
    return ins.split()[0] if ins else ""


def loops(code) -> list:
    """Each branch back to an earlier address: the loop's span, length and
    opcode mix (innermost first: shortest span first)."""
    out = []
    for addr, ins in code:
        if opcode(ins) != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", ins)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target > addr:
            continue
        body = [opcode(i) for a, i in code if target <= a <= addr]
        mix = collections.Counter(op.split(".")[0] for op in body)
        out.append({"from": hex(target), "to": hex(addr),
                    "instructions": len(body),
                    "mix": dict(mix.most_common(12))})
    return sorted(out, key=lambda x: x["instructions"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--functions", nargs="*",
                    default=["regen_kernel", "park_render_kernel",
                             "stream_kernel", "count_kernel", "f64_kernel",
                             "compact_kernel"])
    ap.add_argument("--sources", nargs="*", default=None)
    args = ap.parse_args()

    import raytracingincuda_torch
    from raytracingincuda_torch.ops import _build

    nvcc = _build.nvcc_path()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    res = {"tag": args.tag,
           "package": str(Path(raytracingincuda_torch.__file__).parent),
           "flags": flags, "kernels": {}}
    with tempfile.TemporaryDirectory() as tmp:
        cus = [cu for cu in sorted(_build.CSRC_DIR.glob("*.cu"))
               if args.sources is None or cu.stem in args.sources]
        jobs = []
        for cu in cus:
            obj = Path(tmp) / f"{cu.stem}.o"
            jobs.append((cu, obj, subprocess.Popen(
                [nvcc, *flags, "-Xptxas", "-v", "-c", str(cu), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for cu, obj, proc in jobs:
            text, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {cu.name}:\n{text}")
            info = ptxas(text)
            tile = re.search(r"constexpr int kTile = (\d+);", cu.read_text())
            threads = int(tile.group(1)) if cu.stem == "compact_render" \
                else THREADS
            names = demangle(list(info))
            sass = sass_functions(subprocess.run(
                [cuobjdump, "-sass", str(obj)], capture_output=True,
                text=True).stdout)
            for mangled, props in info.items():
                short = short_name(names[mangled])
                dyn = next((v for k, v in DYNAMIC.items() if short.startswith(k)),
                           0)
                if short.startswith(("stream_kernel", "stream_train_kernel")) \
                        and "kStageBytes" in cu.read_text():
                    dyn = STAGE
                entry = {"source": cu.name, **props, "dynamic_smem": dyn,
                         "threads": threads}
                if "registers" in props:
                    entry["blocks_per_sm"] = blocks_per_sm(
                        props["registers"], props.get("static_smem", 0) + dyn,
                        threads)
                if any(f in short for f in args.functions) and mangled in sass:
                    code = sass[mangled]
                    entry["instructions"] = len(code)
                    entry["loops"] = loops(code)
                    safe = re.sub(r"[^\w]+", "_", short).strip("_")
                    (out_dir / f"sass_{args.tag}_{safe}.txt").write_text(
                        "\n".join(f"/*{a:04x}*/ {i}" for a, i in code) + "\n")
                res["kernels"][short] = entry
    line = json.dumps(res)
    print(line)
    (out_dir / f"resources_{args.tag}.json").write_text(line + "\n")
    for name, e in res["kernels"].items():
        if "registers" in e:
            print(f"{name}: {e['registers']} registers, stack {e.get('stack')}"
                  f", spills {e.get('spill_stores')}/{e.get('spill_loads')}, "
                  f"static smem {e.get('static_smem')}, dynamic "
                  f"{e['dynamic_smem']}, {e['threads']} threads: "
                  f"{e['blocks_per_sm']} blocks an SM")
        for lp in e.get("loops", [])[:6]:
            print(f"    loop {lp['from']}-{lp['to']}: {lp['instructions']} "
                  f"instructions {lp['mix']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
