"""The port's RWKV-6 scan and time-mix (repro_torch.kernels.rwkv6_chunk,
repro_torch.models.modules) against the reference's: the plain scan against
the Pallas kernel (interpret mode) and the token-level recurrence, its
gradients (autograd, and the backward wrapper's plain version) against
jax.vjp, plain models of the CUDA kernels' decompositions (forward: state
pass, output pass with sub-chunked decays; backward: reverse state pass,
per-chunk gradient pass, du summed in chunk order) against both, the time-mix,
channel-mix and rwkv block against the JAX functions, the kernel wrappers'
dispatch and the shapes the kernels take, and a wider model's first steps
against the JAX engine's. The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.kernels.ref import rwkv6_scan_ref
from repro.kernels.rwkv6_chunk import rwkv6_chunk_scan as jax_scan
from repro.models import model as jmodel
from repro.models import modules as jmd
from repro_torch.configs.base import get_config
from repro_torch.kernels import build
from repro_torch.kernels import rwkv6_chunk as rc
from repro_torch.models import model as tmodel
from repro_torch.models import modules as tmd

torch.set_num_threads(1)

# the JAX tests' tolerance for the Pallas kernel against the recurrence
# (tests/test_rwkv6_kernel.py)
SCAN_TOL = dict(rtol=2e-5, atol=2e-5)
# gradients: largest |difference| over the largest |reference value| (the
# criterion the CUDA kernels are held to on the card). Element-wise 2e-5 is
# too tight at K = 64, where a gradient element of |0.1| sums 64-term dot
# products of terms of |5| in another order than XLA
GRAD_REL_TOL = 2e-5
# the autograd.Function's backward on CPU tensors (the backward wrapper's
# plain version) against autograd through the plain forward
BWD_REL_TOL = 1e-5
# at log-decays of -e^8 every chunked scan (this one, the Pallas kernel,
# the JAX model's) differs from the token-level recurrence by ~1e-3 of the
# largest value: the fp32 cumsums reach |2e4| within a chunk and their
# differences keep an absolute error of ~1e-3. Measured 1.6e-3 for the
# Pallas kernel's y and 1.8e-3 for this scan's gradients at the test's
# inputs
LARGE_DECAY_REL_TOL = 5e-3
# modules against the JAX functions: largest |difference| over the largest
# |reference value| (fp32 compute; measured <= 1.6e-5 for the time-mix at
# S=130, whose scan sums in another order)
MODULE_REL_TOL = 1e-4


def _inputs(bh, s, kk, vv, seed=0):
    """The distributions of tests/test_rwkv6_kernel.py, drawn with numpy."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return (n(bh, s, kk) * 0.5, n(bh, s, kk) * 0.5, n(bh, s, vv) * 0.5,
            -np.exp(n(bh, s, kk) - 1.0).astype(np.float32),
            n(bh, kk) * 0.5, n(bh, kk, vv) * 0.3)


def _t(xs):
    return [torch.from_numpy(x.copy()) for x in xs]


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("chunk", [8, 32, 64])
@pytest.mark.parametrize("bh,s,kk,vv", [(2, 64, 16, 16), (3, 128, 16, 24),
                                        (1, 64, 32, 8)])
def test_plain_scan_matches_pallas_kernel_and_recurrence(chunk, bh, s, kk,
                                                         vv):
    args = _inputs(bh, s, kk, vv)
    y, sf = rc.rwkv6_chunk_scan_ref(*_t(args), chunk=chunk)
    jargs = [jnp.asarray(x) for x in args]
    for yr, sr in (jax_scan(*jargs, chunk=chunk, interpret=True),
                   rwkv6_scan_ref(*jargs)):
        np.testing.assert_allclose(y.numpy(), yr, **SCAN_TOL)
        np.testing.assert_allclose(sf.numpy(), sr, **SCAN_TOL)


def test_plain_scan_state_carry():
    """Two halves with the carried state == one full run == the JAX run."""
    r, k, v, logw, u, s0 = _t(_inputs(2, 128, 16, 16, seed=3))
    y_full, s_full = rc.rwkv6_chunk_scan(r, k, v, logw, u, s0, chunk=32)
    h = slice(0, 64), slice(64, 128)
    y1, s1 = rc.rwkv6_chunk_scan(*(x[:, h[0]].contiguous()
                                   for x in (r, k, v, logw)), u, s0, chunk=32)
    y2, s2 = rc.rwkv6_chunk_scan(*(x[:, h[1]].contiguous()
                                   for x in (r, k, v, logw)), u, s1, chunk=32)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               **SCAN_TOL)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), **SCAN_TOL)
    yj, sj = jax_scan(*(jnp.asarray(x.numpy()) for x in (r, k, v, logw, u,
                                                          s0)),
                      chunk=32, interpret=True)
    np.testing.assert_allclose(y_full.numpy(), yj, **SCAN_TOL)
    np.testing.assert_allclose(s_full.numpy(), sj, **SCAN_TOL)


def test_plain_scan_returns_the_chunk_start_states():
    r, k, v, logw, u, s0 = _t(_inputs(2, 96, 8, 8, seed=4))
    _, sf, states = rc.rwkv6_chunk_scan_ref(r, k, v, logw, u, s0, chunk=32,
                                            states=True)
    assert states.shape == (2, 3, 8, 8)
    assert torch.equal(states[:, 0], s0)
    _, s_one = rc.rwkv6_chunk_scan_ref(*(x[:, :32].contiguous()
                                         for x in (r, k, v, logw)), u, s0,
                                       chunk=32)
    torch.testing.assert_close(states[:, 1], s_one, rtol=0, atol=0)


def _cotangents(bh, s, kk, vv, seed=9):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, s, vv)).astype(np.float32),
            rng.standard_normal((bh, kk, vv)).astype(np.float32))


GRAD_CASES = [(2, 64, 16, 16, 8), (3, 128, 16, 24, 32), (1, 64, 32, 8, 64),
              (2, 192, 64, 64, 64)]


def _vjp(args, dy, dsf):
    _, vjp = jax.vjp(rwkv6_scan_ref, *(jnp.asarray(x) for x in args))
    return vjp((jnp.asarray(dy), jnp.asarray(dsf)))


@pytest.mark.parametrize("bh,s,kk,vv,chunk", GRAD_CASES)
def test_gradients_match_jax_vjp(bh, s, kk, vv, chunk):
    """Gradients in r, k, v, logw, u and s0 for a nonzero dy and ds_final:
    autograd through the plain forward, and the backward wrapper on CPU
    tensors (its plain version), both against jax.vjp of the
    recurrence."""
    args = _inputs(bh, s, kk, vv, seed=bh + s)
    dy, dsf = _cotangents(bh, s, kk, vv)
    want = _vjp(args, dy, dsf)
    ts = [x.requires_grad_(True) for x in _t(args)]
    y, sf = rc.rwkv6_chunk_scan(*ts, chunk=chunk)
    auto = torch.autograd.grad((y, sf), ts,
                               (torch.from_numpy(dy), torch.from_numpy(dsf)))
    _, _, states = rc.rwkv6_chunk_scan_ref(*(x.detach() for x in ts),
                                           chunk=chunk, states=True)
    wrapped = rc.rwkv6_chunk_scan_bwd(*(x.detach() for x in ts[:5]), states,
                                      torch.from_numpy(dy),
                                      torch.from_numpy(dsf), chunk=chunk)
    for name, a, e, j in zip(("r", "k", "v", "logw", "u", "s0"), auto,
                             wrapped, want):
        assert _rel_err(a, j) <= GRAD_REL_TOL, name
        assert _rel_err(e, j) <= GRAD_REL_TOL, name


def test_gradients_take_large_decays():
    """logw down to -e^8 (the model's clip): e^{-cw} would overflow, the
    pairwise differences do not; y, s_final and every gradient stay finite
    and agree with the recurrence and jax.vjp to the chunked form's own
    fp32 error."""
    args = list(_inputs(2, 128, 16, 16, seed=11))
    args[3][:, ::7] = -np.float32(np.exp(8.0))
    dy, dsf = _cotangents(2, 128, 16, 16)
    want = _vjp(args, dy, dsf)
    ts = [x.requires_grad_(True) for x in _t(args)]
    y, sf = rc.rwkv6_chunk_scan(*ts, chunk=64)
    got = torch.autograd.grad((y, sf), ts, (torch.from_numpy(dy),
                                            torch.from_numpy(dsf)))
    yj, sj = rwkv6_scan_ref(*(jnp.asarray(x) for x in args))
    for name, a, j in zip(("y", "s_final", "r", "k", "v", "logw", "u",
                           "s0"), (y, sf, *got), (yj, sj, *want)):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, j) <= LARGE_DECAY_REL_TOL, name


# ---------------------------------------------------------------------------
# The CUDA forward's decomposition, modelled on the CPU
# ---------------------------------------------------------------------------

def _state_pass(k, v, logw, s0, chunk):
    """The forward's only sequential part: the state at the start of every
    chunk and the final state, S <- diag(e^T) S + (k e^{T-cw})^T v."""
    st, starts = s0, []
    for c0 in range(0, k.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        cw = torch.cumsum(logw[:, sl], dim=1)
        total = cw[:, -1:]
        starts.append(st)
        st = (st * torch.exp(total).transpose(1, 2)
              + (k[:, sl] * torch.exp(total - cw)).transpose(1, 2) @ v[:, sl])
    return torch.stack(starts, dim=1), st


def _output_chunk(r, k, v, logw, u, st, sub):
    """y of one chunk from its start state alone. A's diagonal sub-chunk
    blocks take pairwise e^{cx[t]-cw[i]}; a block below them is a product
    of r e^{cx-b} and k e^{b-cw}, factored at the start b of t's sub-chunk
    (both exponents <= 0 up to the cumsum's rounding); A's diagonal holds
    the bonus."""
    bh, c, _ = r.shape
    cw = torch.cumsum(logw, dim=1)
    cx = cw - logw
    ulp = 4 * torch.finfo(torch.float32).eps * float(cw.abs().max())
    tri = torch.ones((sub, sub), dtype=torch.bool).tril(-1)[None, :, :, None]
    att = torch.zeros((bh, c, c))
    for p0 in range(0, c, sub):
        tp = slice(p0, p0 + sub)
        pair = torch.where(tri, cx[:, tp, None, :] - cw[:, None, tp, :],
                           -torch.inf)
        att[:, tp, tp] = torch.einsum("btk,bik,btik->bti", r[:, tp], k[:, tp],
                                      torch.exp(pair))
        if p0:
            b = cx[:, p0:p0 + 1]
            up, down = cx[:, tp] - b, b - cw[:, :p0]
            assert float(up.max()) <= ulp and float(down.max()) <= ulp
            att[:, tp, :p0] = ((r[:, tp] * torch.exp(up))
                               @ (k[:, :p0] * torch.exp(down)).transpose(1, 2))
    diag = torch.arange(c)
    att[:, diag, diag] = torch.einsum("btk,bk,btk->bt", r, u, k)
    return (r * torch.exp(cx)) @ st + att @ v


def _decomposed_scan(r, k, v, logw, u, s0, chunk):
    """The CUDA forward's design in plain PyTorch: a state pass, then an
    output pass in which every chunk is independent."""
    states, s_final = _state_pass(k, v, logw, s0, chunk)
    # a chunk shorter than the CUDA forward's sub-chunk is one sub-chunk
    sub = min(rc.SUB, chunk)
    ys = [_output_chunk(*(x[:, c0:c0 + chunk] for x in (r, k, v, logw)), u,
                        states[:, c0 // chunk], sub)
          for c0 in range(0, r.shape[1], chunk)]
    return torch.cat(ys, dim=1), s_final, states


def _reverse_state_pass(r, dy, logw, ds_final, chunk):
    """The backward's only sequential part, the forward's state pass run
    backwards: dS <- diag(e^T) dS + (r e^{cx})^T dy over the chunks in
    descending order, from ds_final. Returns the gradient of the state
    after every chunk (index c holds dS_{c+1}) and ds0."""
    ds, after = ds_final, []
    for c0 in reversed(range(0, r.shape[1], chunk)):
        sl = slice(c0, c0 + chunk)
        cw = torch.cumsum(logw[:, sl], dim=1)
        cx = cw - logw[:, sl]
        total = cw[:, -1:]
        after.append(ds)
        ds = (ds * torch.exp(total).transpose(1, 2)
              + (r[:, sl] * torch.exp(cx)).transpose(1, 2) @ dy[:, sl])
    return torch.stack(after[::-1], dim=1), ds


def _grad_chunk(r, k, v, logw, u, dy, st, dst):
    """One chunk's gradients from its start state S and the gradient dS'
    of the state after it alone, as the CUDA gradient pass forms them:
    every pair decay e^{cx[t]-cw[i]} (i < t) pairwise, from a difference
    <= 0. Returns dr, dk, dv, dlogw and the chunk's partial of du."""
    c = r.shape[1]
    cw = torch.cumsum(logw, dim=1)
    cx = cw - logw
    total = cw[:, -1:]
    tri = torch.ones((c, c), dtype=torch.bool).tril(-1)
    decay = torch.exp(torch.where(tri[None, :, :, None],
                                  cx[:, :, None, :] - cw[:, None, :, :],
                                  -torch.inf))                 # [t, i, k]
    att = torch.einsum("btk,bik,btik->bti", r, k, decay)
    datt = torch.where(tri, dy @ v.transpose(1, 2), 0.0)       # dy[t].v[i]
    bonus = torch.einsum("btk,bk,btk->bt", r, u, k)[..., None]
    dbon = (dy * v).sum(-1, keepdim=True)
    dv = (att.transpose(1, 2) @ dy + bonus * dy
          + (k * torch.exp(total - cw)) @ dst)
    dr_inter = torch.exp(cx) * (dy @ st.transpose(1, 2))
    p_r = torch.einsum("bti,bik,btik->btk", datt, k, decay)
    p_k = torch.einsum("bti,btk,btik->bik", datt, r, decay)
    dk_state = torch.exp(total - cw) * (v @ dst.transpose(1, 2))
    dr = dr_inter + p_r + dbon * u[:, None] * k
    dk = p_k + dbon * u[:, None] * r + dk_state
    dcx, dcw = r * (dr_inter + p_r), -k * (p_k + dk_state)
    d_total = (torch.exp(total[:, 0]) * (st * dst).sum(-1)
               + (k * dk_state).sum(1))
    # dlogw[t] = dT + sum_{t' > t} (dcx + dcw)[t'] + dcw[t]
    g = dcx + dcw
    after = torch.flip(torch.cumsum(torch.flip(g, [1]), 1), [1]) - g
    dlogw = d_total[:, None] + after + dcw
    return dr, dk, dv, dlogw, (dbon * r * k).sum(1)


def _decomposed_bwd(r, k, v, logw, u, s0, dy, ds_final, chunk):
    """The CUDA backward's design in plain PyTorch: the chunk-start states
    (the forward's state pass), the reverse state pass, then every chunk's
    gradients on their own, du summed over the chunks in chunk order."""
    states, _ = _state_pass(k, v, logw, s0, chunk)
    dstates, ds0 = _reverse_state_pass(r, dy, logw, ds_final, chunk)
    parts = [_grad_chunk(*(x[:, c0:c0 + chunk] for x in (r, k, v, logw)), u,
                         dy[:, c0:c0 + chunk], states[:, c0 // chunk],
                         dstates[:, c0 // chunk])
             for c0 in range(0, r.shape[1], chunk)]
    dr, dk, dv, dlogw = (torch.cat([p[j] for p in parts], dim=1)
                         for j in range(4))
    return dr, dk, dv, dlogw, sum(p[4] for p in parts), ds0


def _large_decay_inputs(bh, s, kk, vv, seed):
    """logw at both ends of the model's clip: -e^8 on every 7th token and
    -e^-20 on every 5th from the 3rd."""
    args = list(_inputs(bh, s, kk, vv, seed=seed))
    args[3][:, ::7] = -np.float32(np.exp(8.0))
    args[3][:, 3::5] = -np.float32(np.exp(-20.0))
    return args


@pytest.mark.parametrize("chunk", [8, 32, 64])
@pytest.mark.parametrize("bh,s,kk,vv", [(2, 64, 16, 16), (3, 128, 16, 24),
                                        (1, 64, 32, 8)])
def test_decomposition_matches_plain_scan_and_pallas_kernel(chunk, bh, s, kk,
                                                            vv):
    """The state pass + output pass, with the off-diagonal sub-chunk blocks
    factored, gives the plain scan's y, s_final and chunk-start states and
    the Pallas kernel's y and s_final."""
    args = _inputs(bh, s, kk, vv)
    y, sf, states = _decomposed_scan(*_t(args), chunk=chunk)
    yp, sp, stp = rc.rwkv6_chunk_scan_ref(*_t(args), chunk=chunk, states=True)
    yj, sj = jax_scan(*(jnp.asarray(x) for x in args), chunk=chunk,
                      interpret=True)
    for got, want in ((y, yp), (sf, sp), (states, stp), (y, yj), (sf, sj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


@pytest.mark.parametrize("chunk", [32, 64])
def test_decomposition_takes_large_decays(chunk):
    """At logw = -e^8 and -e^-20 the factored blocks neither overflow nor
    lose terms: every output finite and within the chunked form's own fp32
    error of the plain scan, the Pallas kernel and the recurrence."""
    args = _large_decay_inputs(2, 128, 16, 16, seed=11)
    y, sf, states = _decomposed_scan(*_t(args), chunk=chunk)
    yp, sp, stp = rc.rwkv6_chunk_scan_ref(*_t(args), chunk=chunk, states=True)
    jargs = [jnp.asarray(x) for x in args]
    yj, sj = jax_scan(*jargs, chunk=chunk, interpret=True)
    yq, sq = rwkv6_scan_ref(*jargs)
    for name, got, wants in (("y", y, (yp, yj, yq)), ("s_final", sf,
                                                      (sp, sj, sq)),
                             ("states", states, (stp,))):
        assert torch.isfinite(got).all(), name
        for want in wants:
            assert _rel_err(got, want) <= LARGE_DECAY_REL_TOL, name


GRAD_NAMES = ("r", "k", "v", "logw", "u", "s0")


@pytest.mark.parametrize("bh,s,kk,vv,chunk", GRAD_CASES)
def test_decomposed_backward_matches_plain_backward_and_jax_vjp(bh, s, kk, vv,
                                                                chunk):
    """The reverse state pass + the per-chunk gradient pass + du summed in
    chunk order give the plain backward's and jax.vjp's gradients (the
    inputs and cotangents of test_gradients_match_jax_vjp)."""
    args = _inputs(bh, s, kk, vv, seed=bh + s)
    dy, dsf = _cotangents(bh, s, kk, vv)
    got = _decomposed_bwd(*_t(args), torch.from_numpy(dy),
                          torch.from_numpy(dsf), chunk)
    plain = rc.rwkv6_chunk_scan_bwd_ref(*_t(args), torch.from_numpy(dy),
                                        torch.from_numpy(dsf), chunk=chunk)
    want = _vjp(args, dy, dsf)
    for name, a, p, j in zip(GRAD_NAMES, got, plain, want):
        assert _rel_err(a, p.numpy()) <= GRAD_REL_TOL, name
        assert _rel_err(a, j) <= GRAD_REL_TOL, name


@pytest.mark.parametrize("chunk", [32, 64])
def test_decomposed_backward_takes_large_decays(chunk):
    """At logw = -e^8 and -e^-20 every pair decay of the gradient pass and
    the reverse pass's e^{cx} stay finite: each gradient within the chunked
    form's own fp32 error of the plain backward and of jax.vjp."""
    args = _large_decay_inputs(2, 128, 16, 16, seed=11)
    dy, dsf = _cotangents(2, 128, 16, 16)
    got = _decomposed_bwd(*_t(args), torch.from_numpy(dy),
                          torch.from_numpy(dsf), chunk)
    plain = rc.rwkv6_chunk_scan_bwd_ref(*_t(args), torch.from_numpy(dy),
                                        torch.from_numpy(dsf), chunk=chunk)
    want = _vjp(args, dy, dsf)
    for name, a, p, j in zip(GRAD_NAMES, got, plain, want):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, p.numpy()) <= LARGE_DECAY_REL_TOL, name
        assert _rel_err(a, j) <= LARGE_DECAY_REL_TOL, name


@pytest.mark.parametrize("chunk", [16, 32])
def test_reverse_state_pass_gives_the_state_gradients(chunk):
    """The reverse pass's dS at every chunk boundary is the gradient of
    (y, s_final) . (dy, ds_final) in the state there, as autograd finds it
    through the plain forward run chunk by chunk; its last step is ds0."""
    r, k, v, logw, u, s0 = _t(_inputs(2, 96, 16, 8, seed=21))
    dy, dsf = (torch.from_numpy(x) for x in _cotangents(2, 96, 16, 8))
    starts, ys, st = [], [], s0.clone().requires_grad_(True)
    for c0 in range(0, 96, chunk):
        starts.append(st)
        y, st = rc.rwkv6_chunk_scan_ref(*(x[:, c0:c0 + chunk].contiguous()
                                          for x in (r, k, v, logw)), u, st,
                                        chunk=chunk)
        ys.append(y)
    want = torch.autograd.grad((torch.cat(ys, 1), st), starts, (dy, dsf))
    dstates, ds0 = _reverse_state_pass(r, dy, logw, dsf, chunk)
    assert dstates.shape == (2, 96 // chunk, 16, 8)
    np.testing.assert_allclose(ds0.numpy(), want[0].numpy(), **SCAN_TOL)
    for c in range(1, 96 // chunk):
        np.testing.assert_allclose(dstates[:, c - 1].numpy(),
                                   want[c].numpy(), **SCAN_TOL)
    np.testing.assert_array_equal(dstates[:, -1].numpy(), dsf.numpy())


def test_autograd_function_runs_forward_and_backward_wrappers():
    """The CUDA path's autograd.Function, driven with CPU tensors (its two
    wrappers then run their plain versions): same outputs and gradients as
    autograd through the plain forward, with ds_final absent (training
    drops s_final)."""
    r, k, v, logw, u, s0 = _t(_inputs(2, 64, 16, 16, seed=5))
    ts = [x.requires_grad_(True) for x in (r, k, v, logw, u, s0)]
    y, sf = rc._Scan.apply(*ts, 32, True)
    yr, sr = rc.rwkv6_chunk_scan_ref(*ts, chunk=32)
    assert torch.equal(y, yr) and torch.equal(sf, sr)
    dy = torch.from_numpy(_cotangents(2, 64, 16, 16)[0])
    got = torch.autograd.grad(y, ts, dy)
    want = torch.autograd.grad(yr, ts, dy)
    for a, b in zip(got, want):
        assert _rel_err(a, b.numpy()) <= BWD_REL_TOL


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: the wrappers' dispatch sees
    a card's tensor without one."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def test_wrappers_on_cuda_tensors_raise_when_the_library_cannot_load(
        monkeypatch):
    """No fallback: a CUDA tensor goes to the kernel or raises; the plain
    versions are never run for it and no launch is counted."""
    def no_library(name):
        raise OSError(f"cannot load {name}")

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran for CUDA tensors")
    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(build, "_bound", {})
    monkeypatch.setattr(rc, "rwkv6_chunk_scan_ref", no_plain)
    monkeypatch.setattr(rc, "rwkv6_chunk_scan_bwd_ref", no_plain)
    before = (rc.rwkv6_chunk_scan.launches, rc.rwkv6_chunk_scan_bwd.launches)
    args = [x.as_subclass(_FakeCuda) for x in _t(_inputs(2, 64, 16, 16))]
    with pytest.raises(OSError, match="rwkv6_chunk"):
        rc.rwkv6_chunk_scan(*args)
    with pytest.raises(OSError, match="rwkv6_chunk"):
        rc.scan_forward(*args, save_states=True)
    states = torch.zeros(2, 1, 16, 16).as_subclass(_FakeCuda)
    dy = torch.zeros(2, 64, 16).as_subclass(_FakeCuda)
    with pytest.raises(OSError, match="rwkv6_chunk"):
        rc.rwkv6_chunk_scan_bwd(*args[:5], states, dy, args[5])
    assert (rc.rwkv6_chunk_scan.launches,
            rc.rwkv6_chunk_scan_bwd.launches) == before


@pytest.mark.parametrize("shape, chunk, match", [
    ((2, 64, 16, 16), 8, "multiples of 16"),
    ((2, 64, 24, 16), 32, "multiples of 16"),
    ((2, 64, 16, 8), 32, "multiples of 16"),
    ((2, 128, 16, 16), 128, "up to 64"),
    ("unaligned", 32, "16-byte aligned"),
])
def test_cuda_tensors_the_kernels_do_not_take_raise(monkeypatch, shape,
                                                    chunk, match):
    """A CUDA tensor outside the kernels' shapes or alignment raises
    before any library is loaded; the plain version never runs for it."""
    def no_library(name):
        raise AssertionError("the library was loaded for operands the "
                             "kernels do not take")
    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(build, "_bound", {})
    monkeypatch.setattr(rc, "rwkv6_chunk_scan_ref", no_library)
    if shape == "unaligned":
        args = _t(_inputs(2, 64, 16, 16))
        flat = torch.empty(args[0].numel() + 1)
        args[0] = flat[1:].view(args[0].shape).copy_(args[0])
    else:
        args = _t(_inputs(*shape))
    fake = [x.as_subclass(_FakeCuda) for x in args]
    with pytest.raises(ValueError, match=match):
        rc.scan_forward(*fake, chunk=chunk, save_states=True)


@pytest.mark.parametrize("which", ["states", "dy"])
def test_backward_takes_only_aligned_states_and_dy(monkeypatch, which):
    """The backward kernels read states and dy 16 bytes at a time: a CUDA
    tensor whose data is not 16-byte aligned raises before any library is
    loaded, and no launch is counted."""
    def no_library(name):
        raise AssertionError("the library was loaded for operands the "
                             "kernels do not take")
    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(build, "_bound", {})
    args = _t(_inputs(2, 64, 16, 16))
    grads = {"states": torch.zeros(2, 2, 16, 16), "dy": torch.zeros(2, 64, 16)}
    t = grads[which]
    grads[which] = torch.empty(t.numel() + 1)[1:].view(t.shape)
    fake = [x.as_subclass(_FakeCuda) for x in args]
    before = rc.rwkv6_chunk_scan_bwd.launches
    with pytest.raises(ValueError, match=f"{which} whose data is 16-byte"):
        rc.rwkv6_chunk_scan_bwd(*fake[:5], grads["states"].as_subclass(
            _FakeCuda), grads["dy"].as_subclass(_FakeCuda), fake[5],
            chunk=32)
    assert rc.rwkv6_chunk_scan_bwd.launches == before


def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch(
        monkeypatch):
    def no_build(name):
        raise AssertionError("the CUDA library was loaded for CPU tensors")
    monkeypatch.setattr(build, "load", no_build)
    before = (rc.rwkv6_chunk_scan.launches, rc.rwkv6_chunk_scan_bwd.launches)
    args = _t(_inputs(2, 64, 16, 16))
    y, sf, states = rc.scan_forward(*args, chunk=32, save_states=True)
    assert states.shape == (2, 2, 16, 16)
    assert rc.scan_forward(*args, chunk=32)[2] is None
    rc.rwkv6_chunk_scan_bwd(*args[:5], states, torch.ones_like(y),
                            torch.ones_like(sf), chunk=32)
    assert (rc.rwkv6_chunk_scan.launches,
            rc.rwkv6_chunk_scan_bwd.launches) == before


@pytest.mark.parametrize("bad, err, match", [
    (lambda a: [a[0].double()] + a[1:], TypeError, "float32"),
    (lambda a: [a[0].transpose(1, 2).contiguous().transpose(1, 2)] + a[1:],
     ValueError, "contiguous"),
    (lambda a: [x[:, :48].contiguous() if i < 4 else x
                for i, x in enumerate(a)], ValueError, "multiple"),
    (lambda a: a[:4] + [a[4][:, :8].contiguous(), a[5]], ValueError, "u has"),
    (lambda a: a[:5] + [a[5][:1]], ValueError, "s0 has"),
])
def test_wrappers_reject_malformed_operands(bad, err, match):
    args = _t(_inputs(2, 64, 16, 16))
    with pytest.raises(err, match=match):
        rc.rwkv6_chunk_scan(*bad(args), chunk=32)


# ---------------------------------------------------------------------------
# Model building blocks
# ---------------------------------------------------------------------------


def _block_params():
    jcfg = tiny("rwkv6_7b")
    tcfg = dataclasses.replace(get_config("rwkv6_7b").reduced(),
                               compute_dtype="float32")
    block = jax.tree.map(lambda a: np.asarray(a[0]), jmodel.init_params(
        jcfg, jax.random.key(1))["blocks"])
    tblock = tmodel.params_from_jax(block, "cpu")
    return jcfg, tcfg, block, tblock


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_reduced_rwkv6_has_four_heads_of_64():
    cfg = get_config("rwkv6_7b").reduced()
    assert (cfg.d_model, cfg.ssm.head_dim, cfg.head_dim) == (256, 64, 32)
    assert cfg.d_model // cfg.ssm.head_dim == 4


@pytest.mark.parametrize("s", [23, 64, 130])
def test_timemix_matches_reference(s):
    """S = 23 and 130 are padded to a chunk multiple; a nonzero token-shift
    carry and state."""
    jcfg, tcfg, block, tblock = _block_params()
    x, prev = _rand(s, 2, s, jcfg.d_model), _rand(1, 2, jcfg.d_model)
    st = _rand(2, 2, 4, 64, 64, scale=0.1)
    jy, jprev, jst = jmd.rwkv6_timemix(jcfg, block, x, prev, st)
    ty, tprev, tst = tmd.rwkv6_timemix(tcfg, tblock, torch.from_numpy(x),
                                       torch.from_numpy(prev),
                                       torch.from_numpy(st))
    assert _rel_err(ty, jy) <= MODULE_REL_TOL
    assert _rel_err(tst, jst) <= MODULE_REL_TOL
    assert np.array_equal(tprev.numpy(), np.asarray(jprev))


def test_decay_and_channelmix_match_reference():
    jcfg, tcfg, block, tblock = _block_params()
    x, prev = _rand(3, 2, 17, jcfg.d_model), _rand(4, 2, jcfg.d_model)
    assert _rel_err(tmd.rwkv6_decay(tblock, torch.from_numpy(x)),
                    jmd.rwkv6_decay(block, x)) <= MODULE_REL_TOL
    jy, jprev = jmd.rwkv6_channelmix(block, x, prev)
    ty, tprev = tmd.rwkv6_channelmix(tblock, torch.from_numpy(x),
                                     torch.from_numpy(prev))
    assert _rel_err(ty, jy) <= MODULE_REL_TOL
    assert np.array_equal(tprev.numpy(), np.asarray(jprev))


def test_decay_is_clipped_like_the_reference():
    """exp(clip(w_base + lora, -20, 8)): log-decays in [-e^8, -e^-20]."""
    jcfg, tcfg, block, tblock = _block_params()
    for w0 in (-50.0, 50.0):
        b = dict(block, w_base=np.full_like(block["w_base"], w0))
        tb = dict(tblock, w_base=torch.full_like(tblock["w_base"], w0))
        x = _rand(5, 1, 3, jcfg.d_model)
        got = tmd.rwkv6_decay(tb, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), jmd.rwkv6_decay(b, x),
                                   rtol=1e-6)
        bound = -np.exp(8.0) if w0 > 0 else -np.exp(-20.0)
        np.testing.assert_allclose(got.numpy(), bound, rtol=1e-6)


@pytest.mark.parametrize("s", [23, 64])
def test_rwkv_block_matches_reference(s):
    jcfg, tcfg, block, tblock = _block_params()
    x = _rand(6, 2, s, jcfg.d_model)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    jy, jaux = jmodel.apply_block(jcfg, block, x, pos, kind="rwkv")
    ty, taux = tmodel.apply_block(tcfg, tblock, torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()), kind="rwkv")
    assert _rel_err(ty, jy) <= MODULE_REL_TOL
    assert float(taux) == float(jaux) == 0.0
    assert tmodel.main_stack_kind(tcfg) == jmodel.main_stack_kind(jcfg)


def test_cli_trains_reduced_rwkv6_on_the_cpu():
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "rwkv6-7b", "--reduced", "--steps", "2", "--global-batch", "4",
         "--micro-batches", "2", "--seq-len", "32", "--log-every", "1",
         "--accumulation", "adama", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("[train] step") == 2


def test_lr_sweep_runs_each_learning_rate_from_the_same_start():
    """Every learning rate starts from the same params and data (equal
    step-1 losses) and then diverges from the others."""
    import contextlib
    import io
    import json

    from repro_torch.launch import lr_sweep
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lr_sweep.main(["--arch", "rwkv6-7b", "--reduced", "--lrs", "1e-2",
                       "1e-4", "--steps", "2", "--seq-len", "32",
                       "--global-batch", "4", "--micro-batches", "2",
                       "--device", "cpu"])
    rows = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert [r["lr"] for r in rows] == [1e-2, 1e-4]
    (a0, a1), (b0, b1) = (r["losses"] for r in rows)
    assert a0 == b0 and a1 != b1


@pytest.mark.parametrize("lr, spikes", [(1e-3, True), (1e-4, False)])
def test_wide_rwkv6_loss_spike_is_the_references(lr, spikes):
    """At d_model 1024 (16 heads; the reduced model has 256) a constant lr
    of 1e-3 lifts the step-2 loss far above step 1's, in the reference's
    engine as in the port's, and 1e-4 does not: the spike belongs to the
    configuration (Adam's step-1 update of ~lr per element, summed
    coherently over d_model inputs), not to the port. Losses agree to
    1e-5 relative (measured 2.7e-6 at the spike)."""
    from repro.configs import OptimizerConfig as JaxOptimizerConfig
    from repro.configs import get_config as jax_get_config
    from repro.core.accumulation import make_train_step as jax_step
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.core.accumulation import make_train_step
    from repro_torch.data import make_data

    shape = dict(num_layers=2, d_model=1024, n_heads=16, n_kv_heads=16,
                 d_ff=3584, vocab_size=512, compute_dtype="float32")
    jcfg = dataclasses.replace(jax_get_config("rwkv6_7b"), **shape)
    tcfg = dataclasses.replace(get_config("rwkv6_7b"), **shape)
    data = make_data(tcfg, 64, 4, seed=5)
    batches = [data.batch(i) for i in range(2)]
    step, init = jax_step(jcfg, JaxOptimizerConfig(
        name="adama", accumulation="adama", micro_batches=2,
        use_pallas=True, arena=True, lr=lr))
    step = jax.jit(step)
    params = jmodel.init_params(jcfg, jax.random.key(0))
    tree = tmodel.Model(tcfg, tmodel.params_from_jax(
        jax.tree.map(np.asarray, params), "cpu")).tree()
    state, want = init(params), []
    for b in batches:
        params, state, metrics = step(params, state,
                                      {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(metrics["loss"]))
    del params, state
    step, init = make_train_step(tcfg, OptimizerConfig(
        accumulation="adama", micro_batches=2, lr=lr))
    state, got = init(tree), []
    for b in batches:
        tree, state, metrics = step(tree, state,
                                    {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        got.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    for losses in (want, got):
        assert (losses[1] > 1.3 * losses[0]) == spikes, losses
