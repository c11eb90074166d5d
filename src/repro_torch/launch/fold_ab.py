"""Time the arena folds of this checkout's csrc/fused_step.cu against those
of another checkout's, in turns on one GPU, and hold the two bit for bit.

Both sources are compiled with the same nvcc flags (kernels/build.py) into
two libraries, bound to the same launchers. At the stablelm-1.6b arena
(1,607,424 rows of 1024) each case runs once on clones of one state with
each library, and every column of the state must come out equal, bit for
bit; then the two are timed in turns (other, this, this, other), CUDA
events around KERNEL_REPS back-to-back launches, the median of RUNS runs,
against the bound of the bytes the fold must move (g read once at
its wire's width, the slice's state read and written once). Each case's
launcher arguments are built once, so a timed launch costs the host one
ctypes call (through the Python wrappers, as chip_smoke.py times them, a
call costs the host about 0.1 ms, more than a layer slice's kernel). The
cases: the fold of the whole arena, layer 0's slice and the rest slice,
on the fp32, bf16 and e4m3 wires (the e4m3 codes as kernels/fp8_wire.py
encodes the gradient), for each pair of `--pairs` (guarded with ok = 1
too, checked but not timed, for `--guarded` pairs).

  PYTHONPATH=src python -m repro_torch.launch.fold_ab --against DIR

DIR is the root of the other checkout (e.g. a `git archive` of the parent
commit unpacked under build/). `--sass` also prints, for each
rowcol_fold_kernel and int8-m arena_fold_kernel instantiation of each
library, ptxas' registers, stack frame and spills, and the static SASS
instruction count of its row loop on the fall-through path (`loop_counts`;
cuobjdump -sass), per row and per element (/ 32: a warp instruction is 32
lane instructions, a row 1024 elements). Prints one JSON line per case
and, where `--out` is given, writes them there too. Exits 1 if any case
differs.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, fused_step

LANES = fused_step.LANES
KERNEL_REPS = 20
RUNS = 8                 # CUDA-event-timed runs a figure (their median)
HBM_BYTES_PER_S = 3.35e12
WIRE_BYTES = {"fp32": 4, "bf16": 2, "e4m3": 1}
# bytes per element of each codec's row-indexed columns (the (rows, 1)
# scale and statistic columns and rowcol's (1, 1024) column sums are
# counted per row / once)
M_BYTES = {"fp32": 4, "int8": 1}
V_BYTES = {"fp32": 4, "int8": 1, "factored": 0, "rowcol": 0}
ROW_COLS = {"int8": 1, "factored": 1, "rowcol": 1, "fp32": 0}


def bound_ms(pair: str, wire: str, n_rows: int) -> float:
    """The least time a fold of `pair` ("m/v") on `wire` over `n_rows`
    arena rows can take on the card: g read once at its wire's width (the
    e4m3 wire's (rows, 1) scale column too), the slice's state columns
    read and written once, over HBM_BYTES_PER_S."""
    m_codec, v_codec = pair.split("/")
    n = n_rows * LANES
    state = 2 * (n * (M_BYTES[m_codec] + V_BYTES[v_codec]) +
                 4 * n_rows * (ROW_COLS[m_codec] + ROW_COLS[v_codec]))
    return (WIRE_BYTES[wire] * n + state +
            (4 * n_rows if wire == "e4m3" else 0)) / HBM_BYTES_PER_S * 1e3


def _compile(src: Path, tag: str):
    """nvcc `src` with the port's flags into build/; (library, ptxas
    output)."""
    key = hashlib.sha256(src.read_bytes() +
                         " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"{tag}-{key}.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in fused_step.SIGNATURES.items():
        if fn.startswith("arena_fold"):
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
    return lib, out, proc.stdout + proc.stderr


_KERNEL = re.compile(r"(rowcol_fold_kernel|arena_fold_kernel)ILi(\d)E"
                     r"(?:Li(\d)E)?Lb(\d)ELi(\d)E")


def _kernel_name(mangled: str):
    """'rowcol<int8> G=0 W=2' style name of a fold instantiation, or None
    (arena_fold_kernel only for int8 m)."""
    k = _KERNEL.search(mangled)
    if not k:
        return None
    kind, mk, vk, g, w = k.groups()
    wire = ("fp32", "bf16", "e4m3")[int(w)]
    m = ("fp32", "int8")[int(mk)]
    if kind == "rowcol_fold_kernel":
        return f"rowcol {m}/rowcol guarded={g} wire={wire}"
    if mk != "1":
        return None
    v = ("fp32", "int8", "factored", "rowcol")[int(vk)]
    return f"arena {m}/{v} guarded={g} wire={wire}"


def ptxas_lines(text: str):
    """{kernel: {registers, stack_frame, spill_stores, spill_loads}} from
    nvcc -Xptxas -v output."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            cur = _kernel_name(m.group(1))
            if cur:
                out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack_frame=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out[cur]["smem"] = int(m.group(1))
    return out


def sass_loops(lib_path: Path):
    """{kernel: instructions a row} from cuobjdump -sass of the library."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    return loop_counts(subprocess.run([str(cuobjdump), "-sass",
                                       str(lib_path)], capture_output=True,
                                      text=True, check=True).stdout)


def loop_counts(sass: str):
    """{kernel: static instructions of the row loop on its fall-through
    path}: the loop is the conditional backward branch that spans the
    most instructions; code that an unconditional forward branch inside it
    jumps over (an else branch: the int8 m re-encode's divide, taken by
    rows outside the reciprocal's range) is not counted."""
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name = _kernel_name(chunk.split(None, 1)[0])
        if name is None:
            continue
        addrs, branches = [], []
        for line in chunk.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*)", line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            addrs.append(addr)
            b = re.match(r"(@!?U?P\w+\s+)?BRA\b.*?(0x[0-9a-f]+)", m.group(2))
            if b:
                branches.append((addr, int(b.group(2), 16), bool(b.group(1))))
        loops = [(a, t) for a, t, cond in branches if cond and t <= a]
        if not loops:
            out[name] = 0
            continue
        a, t = max(loops, key=lambda x: x[0] - x[1])
        body = {x for x in addrs if t <= x <= a}
        for b, tb, cond in branches:
            if not cond and t <= b < tb <= a:
                body -= {x for x in addrs if b < x < tb}
        out[name] = len(body)
    return out


def timed_ms(fn, runs):
    fn()
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(KERNEL_REPS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / KERNEL_REPS)
    return statistics.median(times)


def _state(gen, m_codec, v_codec, rows):
    def col(scale, n=rows, width=1):
        return torch.rand((n, width), generator=gen, device="cuda") * scale
    if m_codec == "int8":
        m = (torch.randint(-127, 128, (rows, LANES), generator=gen,
                           device="cuda", dtype=torch.int8), col(1e-5))
    else:
        m = (torch.randn((rows, LANES), generator=gen, device="cuda") * 1e-3,)
    if v_codec == "int8":
        v = (torch.randint(0, 128, (rows, LANES), generator=gen,
                           device="cuda", dtype=torch.int8), col(1e-8))
    elif v_codec == "rowcol":
        v = (col(1e-3), col(1.0, 1, LANES))
    elif v_codec == "factored":
        v = (col(1e-6),)
    else:
        v = ((torch.randn((rows, LANES), generator=gen, device="cuda")
              * 1e-6).abs(),)
    return m, v


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _launcher(lib, mk, vk, m, v, g, gs, off, guard):
    """A call of one library's fold launcher with its arguments (and a
    scratch) built once, so that a timed call costs the host one ctypes
    call."""
    args = fused_step.fold_args(
        mk, vk, m, v, g, off, 0.9, 0.999, 1.0 / 8, (0.9, 0.999),
        fused_step.fold_scratch(vk, g.shape[0], g.device), gs)
    name = "arena_fold" + ("_e4m3" if gs is not None else "") + \
        ("_guarded" if guard is not None else "") + "_launch"
    fn = getattr(lib, name)
    args += () if guard is None else (guard.data_ptr(),)
    args += (torch.cuda.current_stream().cuda_stream,)

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return call


def _slabs(gen, rows):
    """The three wires' slabs of one gradient: fp32, bf16, and its e4m3
    codes with their (rows, 1) scale column as the fp8 wire encodes them
    (kernels/fp8_wire.py, at a loss scale of 2^15)."""
    from repro_torch.kernels import fp8_wire
    g = torch.randn((rows, LANES), generator=gen, device="cuda")
    codes, gs = fp8_wire.fp8_encode(g * 2.0 ** 15)
    return {"fp32": (g, None), "bf16": (g.to(torch.bfloat16), None),
            "e4m3": (codes, gs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", required=True,
                    help="root of the other checkout")
    ap.add_argument("--pairs", nargs="+",
                    default=["int8/rowcol", "fp32/rowcol", "int8/int8",
                             "int8/factored"])
    ap.add_argument("--guarded", nargs="*", default=["int8/rowcol"])
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fold_ab: CUDA is not available", file=sys.stderr)
        return 2
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    here = build.CSRC / "fused_step.cu"
    there = Path(a.against) / "src/repro_torch/kernels/csrc/fused_step.cu"
    libs = {}
    for tag, src in (("other", there), ("this", here)):
        lib, path, text = _compile(src, f"fold_ab_{tag}")
        libs[tag] = lib
        if a.sass:
            ptx, loops = ptxas_lines(text), sass_loops(path)
            for k in sorted(set(ptx) | set(loops)):
                emit({"build": tag, "kernel": k, **ptx.get(k, {}),
                      "loop_instructions": loops.get(k),
                      "per_element": (loops[k] / 32 if loops.get(k)
                                      else None)})

    from repro_torch.configs.base import get_config
    from repro_torch.core.arena import build_layout
    from repro_torch.models.model import init_params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(get_config("stablelm_1_6b"), gen)
    layout = build_layout(params)
    del params
    torch.cuda.empty_cache()
    rows = layout.rows
    spec, rest = layout.stack("blocks"), layout.rest
    cases = {"whole": (rows, 0), "layer": (spec.layer_rows, spec.row),
             "rest": (rest.rows, rest.row)}
    slabs = _slabs(gen, rows)
    differ = 0
    for pair in a.pairs:
        m_codec, v_codec = pair.split("/")
        mk = fused_step.kernel_codec("m", m_codec)
        vk = fused_step.kernel_codec("v", v_codec)
        m, v = _state(gen, m_codec, v_codec, rows)
        for wire in WIRE_BYTES:
            g_all, gs_all = slabs[wire]
            for case in cases:
                n_rows, off = cases[case]
                g = g_all[:n_rows]
                gs = None if gs_all is None else gs_all[:n_rows]
                forms = [None]
                if pair in a.guarded:
                    forms.append(torch.tensor([0.9, 0.999, 1.0, 0.125],
                                              device="cuda"))
                equal = True
                for guard in forms:
                    out = {}
                    for tag, lib in libs.items():
                        mm = tuple(x.clone() for x in m)
                        vv = tuple(x.clone() for x in v)
                        _launcher(lib, mk, vk, mm, vv, g, gs, off,
                                  guard)()
                        out[tag] = mm + vv
                    torch.cuda.synchronize()
                    equal &= all(torch.equal(_bits(x), _bits(y)) for x, y in
                                 zip(out["other"], out["this"]))
                    del out
                differ += not equal
                calls = {tag: _launcher(lib, mk, vk, m, v, g, gs, off, None)
                         for tag, lib in libs.items()}
                t = [timed_ms(calls[tag], RUNS)
                     for tag in ("other", "this", "this", "other")]
                bound = bound_ms(pair, wire, n_rows)
                this_ms = statistics.median(t[1:3])
                other_ms = statistics.median([t[0], t[3]])
                emit({"pair": pair, "wire": wire, "case": case,
                      "rows": n_rows, "row_offset": off,
                      "bitwise_equal": equal,
                      "guarded_checked": len(forms) > 1,
                      "ms_in_turns": {"other": [t[0], t[3]],
                                      "this": t[1:3]},
                      "this_ms": this_ms, "other_ms": other_ms,
                      "this_over_other": this_ms / other_ms,
                      "bound_ms": bound,
                      "this_share_of_bound": bound / this_ms})
        del m, v
        torch.cuda.empty_cache()
    emit({"cases_differing": differ})
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
