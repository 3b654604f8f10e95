"""``jax.random.normal`` in float32 without jax, bit for bit.

jax computes a float32 normal as ``sqrt(2) * erf_inv(u)`` with ``u``
uniform in ``(nextafter(-1, 0), 1)``, and XLA on the CPU evaluates
``erf_inv`` (and the ``log1p`` inside it) as float32 polynomials whose
multiply-adds it contracts into FMAs.  :func:`erf_inv_f32` follows those
instructions one by one, each FMA rounded once (:func:`_fma`), so a draw is
the reference's bit for bit; a float64 ``erfinv`` would leave it up to
5.8e-6 off.  ``tests/test_torch_rng.py`` checks it against
``jax.lax.erf_inv`` on every one of the 2^23 uniforms a normal can draw.
Both model families draw their initial weights with :func:`normal`
(``models/gnn/init.py``, ``models/transformer/model.py``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.pipeline import threefry

F32, F64 = np.float32, np.float64


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once.  The product is exact in
    float64 and TwoSum gives the float64 sum's error, so the one case
    where rounding the float64 sum to float32 rounds twice (the sum lies
    exactly halfway between two floats and the error is not zero) is
    moved one float64 step towards the exact value first."""
    p = np.asarray(a, F32).astype(F64) * np.asarray(b, F32).astype(F64)
    c = np.asarray(c, F32).astype(F64)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    half = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(1 << 28)
    fix = half & (err != 0)
    if fix.any():
        s = np.where(fix, np.nextafter(s, s + err), s)
    return s.astype(F32)


# XLA's log1p (a Cephes rational function below sqrt(2) - 1) and its
# float32 log (Eigen's plog: mantissa in [sqrt(1/2), sqrt(2)), a degree-8
# polynomial, the exponent times ln 2 in two parts)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG_P = tuple(F32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LN2_HI, _LN2_LO = F32(0.693359375), F32(-2.12194440e-4)
_SQRT_HALF = F32(0.707106781186547524)
# XLA's ErfInv32 (Giles 2010): w < 5 and w >= 5
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _log_f32(v: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log`` on the CPU, instruction by instruction."""
    vm = np.maximum(v, F32(np.finfo(F32).tiny))
    vb = vm.view(np.uint32)
    e = ((vb >> np.uint32(23)).astype(np.int32) - 127).astype(F32) + F32(1)
    m = ((vb & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(F32)
    low = m < _SQRT_HALF
    x = (m + F32(-1)) + np.where(low, m, F32(0))
    e = np.where(low, e - F32(1), e)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y1 = _fma(x, _fma(x, p[0], p[1]), p[2])
    y2 = _fma(x, _fma(x, p[3], p[4]), p[5])
    y3 = _fma(x, _fma(x, p[6], p[7]), p[8])
    y = _fma(x3, _fma(y1, x3, y2), y3)
    y = _fma(y, x3, e * _LN2_LO)
    r = _fma(F32(-0.5), x2, x) + y
    r = _fma(e, _LN2_HI, r)
    r = np.where(v <= 0, F32(np.nan), r)
    r = np.where(v == np.inf, F32(np.inf), r)
    return np.where(v == 0, F32(-np.inf), r)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log1p`` on the CPU: ``x - x^2/2 + x^3 P(x)/Q(x)``
    for ``|x| < sqrt(2) - 1``, else ``log(1 + x)``."""
    d = np.full_like(x, F32(_LOG1P_DEN[0]))
    for c in _LOG1P_DEN[1:]:
        d = _fma(d, x, F32(c))
    n = np.full_like(x, F32(_LOG1P_NUM[0]))
    for c in _LOG1P_NUM[1:]:
        n = _fma(n, x, F32(c))
    x2 = x * x
    small = x + _fma(x2, F32(-0.5), (x2 * x) * (n / d))
    return np.where(np.abs(x) < F32(0.41421356237309504880), small,
                    _log_f32(x + F32(1)))


def erf_inv_f32(u: np.ndarray) -> np.ndarray:
    """``jax.lax.erf_inv`` of a float32 array, as XLA computes it on the
    CPU."""
    u = np.asarray(u, F32)
    with np.errstate(invalid="ignore", divide="ignore"):
        lg = _log1p_f32(-u * u)
        lt = lg > F32(-5)                       # w = -log1p(-u^2) < 5
        w = np.where(lt, F32(-2.5) - lg, np.sqrt(-lg) + F32(-3))
        p = _fma(np.where(lt, F32(_ERFINV_LT[0]), F32(_ERFINV_GE[0])), w,
                 np.where(lt, F32(_ERFINV_LT[1]), F32(_ERFINV_GE[1])))
        for a, b in zip(_ERFINV_LT[2:], _ERFINV_GE[2:]):
            p = _fma(w, p, np.where(lt, F32(a), F32(b)))
        p = np.where(np.abs(u) == F32(1), F32(np.inf), p)
        return u * p


CHUNK = 1 << 18        # elements per erf_inv pass (its temporaries fit L2)


def normal(k: threefry.Key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(k, shape, jnp.float32)``, bit for bit.  The
    elementwise ``erf_inv`` runs over chunks of ``CHUNK`` elements on a
    thread pool (numpy's ufuncs release the GIL)."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    lo = np.nextafter(F32(-1), F32(0), dtype=F32)
    u = threefry.uniform(k, shape, float(lo), 1.0).numpy()
    flat = u.reshape(-1)
    parts = [flat[i:i + CHUNK] for i in range(0, flat.size, CHUNK)]
    if len(parts) <= 1:
        return erf_inv_f32(u) * F32(np.sqrt(2))
    with ThreadPoolExecutor(min(len(parts), os.cpu_count() or 1)) as pool:
        out = np.concatenate(list(pool.map(erf_inv_f32, parts)))
    return out.reshape(u.shape) * F32(np.sqrt(2))
