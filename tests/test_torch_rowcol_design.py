"""The identities the int8-m rowcol fold's design (csrc/fused_step.cu,
`rowcol_fold_kernel`) rests on, where they can be stated without the card:

  - the pair decode: every float8_e4m3fn code widened through float16
    (cvt.rn.f16x2.e4m3x2, then cvt.f32.f16 on the card; torch's casts
    here) equals the kernel's bit decode (`e4m3_to_f32`, transcribed) and
    the reference's float8_e4m3fn -> float32 cast, NaN codes as NaN;
  - the re-encode's quotient through the row's reciprocal (q = x * r, one
    fma residual step, r = rcp.rn(sd)), computed with exact rationals from
    float32 inputs, gives the IEEE division's code trunc(fl(x / sd))
    clamped to [-127, 127] (and the correctly rounded quotient itself) for
    every divisor in the range the kernel takes it (2^-103 <= sd < 2^126),
    on seeded samples that hold the worst cases: quotients within a few
    ulps of every integer up to 128, and x = sd (1 - 2^-24);
  - on int8 m rows, the reference's encode (repro q8s_encode_rows), the
    port's plain version and that model of the kernel give the same codes;
  - the card check's names (fused_step.EXACTNESS_CHECKS) are the kernel's
    XCheck enum, in order, and the check refuses the CPU.

chip_smoke.py holds the same substitutions on the card, bit for bit, over
exhaustive and dense inputs (fused_step.fold_exactness).
"""
import math
import re
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import adama_accum as jaccum
from repro_torch.kernels import adama_accum, fused_step

CSRC = Path(fused_step.__file__).resolve().parent / "csrc" / "fused_step.cu"
TINY = Fraction(1, 2 ** 126)
Q8_MAX = 127
RECIP_LO, RECIP_HI = 2.0 ** -103, 2.0 ** 126


def e4m3_to_f32(b: int) -> float:
    """csrc/fused_step.cu's e4m3_to_f32, transcribed: (sign, 4 exponent
    bits of bias 7, 3 mantissa bits), S.1111.111 NaN, no Inf."""
    sign, e, m = b >> 7, (b >> 3) & 0xF, b & 7
    if e == 0xF and m == 7:
        bits = 0x7FC00000
    elif e == 0:
        bits = np.float32(m * 2.0 ** -9).view(np.uint32)
    else:
        bits = ((e + 120) << 23) | (m << 20)
    return np.uint32(int(bits) | (sign << 31)).view(np.float32)


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """Bit for bit, NaN equal to NaN."""
    nan = np.isnan(a) & np.isnan(b)
    return bool(np.all(nan | (a.view(np.uint32) == b.view(np.uint32))))


@pytest.mark.parametrize("exponent", range(16))
def test_e4m3_pair_decode_matches_bit_decode(exponent):
    codes = np.array([(s << 7) | (exponent << 3) | m for s in (0, 1)
                      for m in range(8)], dtype=np.uint8)
    want = np.array([e4m3_to_f32(int(c)) for c in codes], dtype=np.float32)
    via_f16 = torch.from_numpy(codes).view(torch.float8_e4m3fn) \
        .to(torch.float16).to(torch.float32).numpy()
    assert _same(via_f16, want)
    # every e4m3 value is a normal float16 (or zero): the widening is exact
    f16 = torch.from_numpy(codes).view(torch.float8_e4m3fn).to(torch.float16)
    finite = f16[torch.isfinite(f16)]
    assert bool((finite.abs()[finite != 0] >= 2.0 ** -14).all())
    ref = np.asarray(jnp.asarray(codes).view(jnp.float8_e4m3fn)
                     .astype(jnp.float32))
    assert _same(ref, want)


# ---------------------------------------------------------------------------
# The quotient, with exact rationals
# ---------------------------------------------------------------------------


def rn32(v: Fraction) -> Fraction:
    """v rounded to float32, nearest even, with gradual underflow (IEEE,
    no flush); inf beyond the largest finite value."""
    if v == 0:
        return Fraction(0)
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    quantum = Fraction(2) ** (max(e, -126) - 23)
    n = a / quantum
    k = n.numerator // n.denominator
    rest = n - k
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and k % 2):
        k += 1
    out = min(k * quantum, Fraction(2) ** 128)   # 2^128 stands for Inf
    return out if v > 0 else -out


def fl(v: Fraction) -> Fraction:
    return Fraction(0) if abs(v) < TINY else v


def code(q: Fraction) -> int:
    """trunc after the clamp to [-127, 127] (the kernel's order; the same
    code as the clamp after trunc)."""
    q = max(min(q, Fraction(Q8_MAX)), Fraction(-Q8_MAX))
    return math.trunc(q)


def ieee_code(x: Fraction, sd: Fraction) -> int:
    """The expression replaced: trunc(fl(x / sd)) clamped."""
    return math.trunc(max(min(fl(rn32(x / sd)), Fraction(Q8_MAX)),
                          Fraction(-Q8_MAX)))


def recip_quotient(x: Fraction, sd: Fraction) -> Fraction:
    """q8_code_m<true>'s quotient: r = rcp.rn(sd), q0 = x * r, q0 + (x -
    q0 * sd) * r, each rounded once (the last two fmas)."""
    r = rn32(1 / sd)
    q0 = rn32(x * r)
    e = rn32(x - q0 * sd)
    return rn32(e * r + q0)


def _bits32(b: int) -> Fraction:
    return Fraction(float(np.uint32(b).view(np.float32)))


def _ulps(x: Fraction, d: int) -> Fraction:
    b = int(np.float32(float(x)).view(np.uint32))
    return _bits32(b + d)


# divisor binades sampled, from the bottom of the reciprocal's range up
SD_EXPONENTS = (-103, -102, -90, -60, -30, -10, -1, 0, 1, 20, 60, 100, 120,
                125)


def _cases(rng, e):
    mants = [0, 1, 0x7FFFFF, 0x400000, 0x555555] + \
        [int(m) for m in rng.integers(0, 1 << 23, 7)]
    for mant in mants:
        sd = _bits32(((e + 127) << 23) | mant)
        xs = [sd, sd * (1 - Fraction(1, 2 ** 24)), sd * 127, sd * 128]
        for k in [1, 2, 3, 63, 64, 126, 127, 128] + \
                [int(k) for k in rng.integers(1, 128, 6)]:
            if k * sd >= Fraction(2) ** 127:
                continue
            x0 = rn32(k * sd)
            xs += [_ulps(x0, d) for d in (-2, -1, 0, 1, 2)]
        xs += [rn32(sd * Fraction(int(n), 1 << 20))
               for n in rng.integers(0, 128 << 20, 8)]
        for x in xs:
            x = rn32(x)
            if x == 0 or x >= Fraction(2) ** 128:
                continue
            yield sd, x
            yield sd, -x


@pytest.mark.parametrize("e", SD_EXPONENTS)
def test_reciprocal_quotient_gives_the_division_code(e):
    rng = np.random.default_rng(1000 + e)
    n = 0
    for sd, x in _cases(rng, e):
        assert RECIP_LO <= sd < RECIP_HI
        q = recip_quotient(x, sd)
        assert code(q) == ieee_code(x, sd), (float(x), float(sd))
        if abs(x / sd) >= TINY:       # a normal quotient: correctly rounded
            assert q == rn32(x / sd), (float(x), float(sd))
        n += 1
    assert n > 300


def kernel_codes(m: np.ndarray) -> np.ndarray:
    """The kernel's int8 m encode of flushed rows, modelled exactly: the
    row scale as q8_scale takes it, the codes by q8_code_m."""
    out = np.empty(m.shape, dtype=np.int8)
    for i, row in enumerate(m):
        mx = float(np.abs(row).max())
        s = np.float32(mx) * np.float32(1 / 127)
        s = mx if (abs(s) < 2.0 ** -126 and mx > 0) else float(s)
        sd = Fraction(s) if s > 0 else Fraction(1)
        recip = RECIP_LO <= sd < RECIP_HI
        for j, x in enumerate(row):
            xf = Fraction(float(x))
            out[i, j] = code(recip_quotient(xf, sd)) if recip \
                else ieee_code(xf, sd)
    return out


# 1e-33: a scale below 2^-103, where the kernel's rows take the divide
@pytest.mark.parametrize("row_scale", (1e-33, 1e-25, 1e-8, 1.0, 1e30))
def test_int8_m_codes_reference_plain_kernel(row_scale):
    """Rows whose values sit within an ulp of integer multiples of their
    scale, plus random ones: the reference's encode, the port's plain
    version and the kernel's reciprocal codes agree."""
    rng = np.random.default_rng(7)
    rows = 4
    m = (rng.standard_normal((rows, 1024)) * row_scale).astype(np.float32)
    s = (np.abs(m).max(axis=1, keepdims=True) * np.float32(1 / 127)) \
        .astype(np.float32)
    k = (rng.integers(1, 128, (rows, 1024)) *
         rng.choice([-1, 1], (rows, 1024))).astype(np.float32)
    near = (k * s).astype(np.float32)
    near = near.view(np.int32) + rng.integers(-1, 2, (rows, 1024)) \
        .astype(np.int32)
    m[:, :512] = near.view(np.float32)[:, :512]
    m[:, 0] = np.abs(m).max(axis=1)           # the row max itself
    ref_q, ref_s = jaccum.q8s_encode_rows(jnp.asarray(m))
    plain_q, plain_s = adama_accum.q8s_encode_rows(torch.from_numpy(m))
    assert np.array_equal(np.asarray(ref_q), plain_q.numpy())
    assert np.array_equal(np.asarray(ref_s), plain_s.numpy())
    assert np.array_equal(kernel_codes(m), plain_q.numpy())


# ---------------------------------------------------------------------------
# The card check's interface
# ---------------------------------------------------------------------------


def test_exactness_checks_match_the_kernel_enum():
    src = CSRC.read_text()
    body = re.search(r"enum XCheck \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"kX(\w+) = (\d+)", body)
    checks = [n.lower() for n, i in sorted(names, key=lambda x: int(x[1]))
              if n != "Checks"]
    assert tuple(checks) == fused_step.EXACTNESS_CHECKS


def test_exactness_check_refuses_the_cpu():
    with pytest.raises(ValueError, match="card"):
        fused_step.fold_exactness("flush", device="cpu")


# ---------------------------------------------------------------------------
# launch/fold_ab.py's readers of the build (chip_smoke.py's ptxas check)
# ---------------------------------------------------------------------------

_ROWCOL = ("_ZN46_GLOBAL__N__f916afed_13_fused_step_cu_a58cac9218rowcol_fold_"
           "kernelILi{mk}ELb{g}ELi{w}EEEvPvS1_PfP6float4PKvPKfllliiS4_Pjfffff")
_ARENA = ("_ZN46_GLOBAL__N__f916afed_13_fused_step_cu_a58cac9217arena_fold_"
          "kernelILi1ELi1ELb0ELi2EEEvPvS1_S1_S1_PKvPKfllfffffPK6float4")


def test_ptxas_lines_name_each_instantiation():
    from repro_torch.launch.fold_ab import ptxas_lines
    a, b = _ROWCOL.format(mk=1, g=0, w=2), _ROWCOL.format(mk=0, g=1, w=0)
    text = "\n".join([
        f"ptxas info    : Compiling entry function '{a}' for 'sm_90a'",
        f"ptxas info    : Function properties for {a}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 122 registers, used 1 barriers, 32772 bytes "
        "smem, 512 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{b}' for 'sm_90a'",
        f"ptxas info    : Function properties for {b}",
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 32788 bytes "
        "smem, 512 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{_ARENA}' for 'sm_90a'",
        "ptxas info    : Used 96 registers, 512 bytes cmem[0]"])
    assert ptxas_lines(text) == {
        "rowcol int8/rowcol guarded=0 wire=e4m3": dict(
            stack_frame=0, spill_stores=0, spill_loads=0, registers=122,
            smem=32772),
        "rowcol fp32/rowcol guarded=1 wire=fp32": dict(
            stack_frame=8, spill_stores=8, spill_loads=4, registers=128,
            smem=32788),
        "arena int8/int8 guarded=0 wire=e4m3": dict(registers=96)}


def test_loop_counts_take_the_row_loop_without_its_else_branch():
    from repro_torch.launch.fold_ab import loop_counts

    def ins(addr, text):
        return f"        /*{addr:04x}*/   {text} ;   /* 0x0 */"
    body = [ins(0x00, "MOV R1, c[0x0][0x28]")]
    body += [ins(0x10 * i, "FFMA R2, R2, R3, R4") for i in range(1, 10)]
    body += [ins(0xa0, "@P0 BRA 0xe0")]             # if: taken
    body += [ins(0xb0, "FMUL R2, R2, R3"), ins(0xc0, "FMUL R2, R2, R3")]
    body += [ins(0xd0, "BRA 0x110")]                # skips the else
    body += [ins(0x100 - 0x10 * i, "FADD R2, R2, R3") for i in (2, 1)]
    body += [ins(0x100, "MUFU.RCP R5, R2")]
    body += [ins(0x110, "@!P1 BRA 0x10"), ins(0x120, "EXIT"),
             ins(0x130, "BRA 0x130")]
    sass = "Function : " + _ROWCOL.format(mk=1, g=0, w=1) + "\n" + \
        "\n".join(body)
    # the loop 0x10 .. 0x110, less the else branch 0xe0 .. 0x100
    assert loop_counts(sass) == {"rowcol int8/rowcol guarded=0 wire=bf16": 14}
