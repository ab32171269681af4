"""CUDA conformance battery: the port's counterpart of runmat_tpu/tpu_smoke.py.

The same ~150 option-pinned assertions as the JAX package's on-chip
battery (`CASES` and `_cmp` are copies of runmat_tpu/tpu_smoke.py's: the
same MATLAB programs and the same pinned literals), run through a port
session on the card: NaN modes on reductions and sort/unique/setops,
integer saturation and rounding, complex arithmetic, scans,
transcendental ULPs, linear algebra, histcounts and interp lowerings, RNG
determinism and the matmul precision policy.

Each case is one MATLAB program (device inputs via gpuArray, gathered
outputs) plus pinned expectations: literals derived from documented MATLAB
behaviour, not recomputed by an oracle at run time. The same battery runs
on the CPU engine in the tests (tests/test_torch_battery.py), so a failure
on the card isolates a difference of the card, not a stale expectation.

Unlike the JAX package's runner, `run` has no retry, no skip and no
"environment degraded" class: on CUDA each case passes or fails, and any
failure fails the battery. `chip_smoke.py` phase 14 runs it on a card
session.
"""

from __future__ import annotations

import numpy as np

# Each case: (name, matlab_src, [(var, expected, tol), ...])
# expected: list/scalar compared against gather()'d column-major raveled
# values; NaN compares positionally equal. tol=0 means exact.

CASES = [
    ("nan_reductions", """
g = gpuArray([2 NaN 4; 1 5 NaN]);
s_om = gather(sum(g, 'omitnan'));
s_in = gather(sum(g(:)));
m_om = gather(mean(g, 2, 'omitnan'));
mx = gather(max(g, [], 2));
mn = gather(min(g(:)));
mx_in = gather(max(g, [], 2, 'includenan'));
md = gather(median(gpuArray([1 NaN 3 7]), 'omitnan'));
st = gather(std(gpuArray([1 2 NaN 4]), 'omitnan'));
""", [
        ("s_om", [3, 5, 4], 1e-12),
        ("s_in", [np.nan], 0),
        ("m_om", [3, 3], 1e-12),
        ("mx", [4, 5], 0),
        ("mn", [1], 0),
        ("mx_in", [np.nan, np.nan], 0),
        ("md", [3], 0),
        ("st", [np.sqrt(7.0 / 3.0)], 1e-12),
    ]),
    ("nan_sort_unique", """
v = gpuArray([3 NaN 1 NaN 2]);
sa = gather(sort(v));
sd = gather(sort(v, 'descend'));
u = gather(unique(v));
[~, ia] = sort(gpuArray([2 1 2 1]));
ia = gather(ia);
""", [
        # MATLAB: NaNs last in ascend, FIRST in descend; unique keeps each NaN
        ("sa", [1, 2, 3, np.nan, np.nan], 0),
        ("sd", [np.nan, np.nan, 3, 2, 1], 0),
        ("u", [1, 2, 3, np.nan, np.nan], 0),
        ("ia", [2, 4, 1, 3], 0),   # stable ties
    ]),
    ("setops_nan", """
sx = gather(setxor(gpuArray([NaN 1 2]), gpuArray([2 3])));
sd2 = gather(setdiff(gpuArray([NaN 1 5]), gpuArray([5])));
it = gather(intersect(gpuArray([NaN 1 2]), gpuArray([NaN 2])));
un = gather(union(gpuArray([1 NaN]), gpuArray([NaN 2])));
im = gather(ismember(gpuArray([NaN 2]), gpuArray([NaN 2])));
""", [
        ("sx", [1, 3, np.nan], 0),
        ("sd2", [1, np.nan], 0),
        ("it", [2], 0),                      # NaN never intersects
        ("un", [1, 2, np.nan, np.nan], 0),
        ("im", [0, 1], 0),                   # NaN is not a member of anything
    ]),
    ("int_saturation", """
a = gpuArray(int8([100 -100]));
s = gather(a + int8(50));
m = gather(a * int8(2));
d = gather(int8(100) / int8(3));
u = gather(uint8(200) + uint8(100));
n = gather(-int8(-128));
c = gather(int16(32767) + int16(1));
r = gather(int8(2.5));
r2 = gather(int8(-2.5));
r3 = gather(int8(3.5));
""", [
        ("s", [127, -50], 0),                # saturate, not wrap
        ("m", [127, -128], 0),
        ("d", [33], 0),                      # round-half-away: 33.33 -> 33
        ("u", [255], 0),
        ("n", [127], 0),                     # -(-128) saturates to 127
        ("c", [32767], 0),
        ("r", [3], 0),                       # .5 rounds away from zero
        ("r2", [-3], 0),
        ("r3", [4], 0),
    ]),
    ("rounding_modsigns", """
rr = gather(round(gpuArray([2.5 -2.5 3.5 -0.5])));
rd = gather(round(gpuArray(2.567), 2));
fx = gather(fix(gpuArray([2.7 -2.7])));
fl = gather(floor(gpuArray([-2.5 2.5])));
ce = gather(ceil(gpuArray([-2.5 2.5])));
md1 = gather(mod(gpuArray([5 -5 5 -5]), gpuArray([3 3 -3 -3])));
rm1 = gather(rem(gpuArray([5 -5 5 -5]), gpuArray([3 3 -3 -3])));
mz = gather(mod(gpuArray(5), 0));
""", [
        ("rr", [3, -3, 4, -1], 0),           # round half away from zero
        ("rd", [2.57], 1e-12),
        ("fx", [2, -2], 0),
        ("fl", [-3, 2], 0),
        ("ce", [-2, 3], 0),
        ("md1", [2, 1, -1, -2], 0),          # mod takes divisor's sign
        ("rm1", [2, -2, 2, -2], 0),          # rem takes dividend's sign
        ("mz", [5], 0),                      # mod(x,0) == x
    ]),
    ("complex_ops", """
z = gpuArray([1+2i, 3-4i]);
ab = gather(abs(z));
cj = gather(conj(z));
re = gather(real(z)); im = gather(imag(z));
an = gather(angle(gpuArray(-1+0i)));
p = gather(z .* conj(z));
sq = gather(sqrt(gpuArray(-4 + 0i)));
ctp = gather(gpuArray([1+1i; 2-3i])');
""", [
        ("ab", [np.sqrt(5), 5], 1e-12),
        ("cj", [1 - 2j, 3 + 4j], 0),
        ("re", [1, 3], 0),
        ("im", [2, -4], 0),
        ("an", [np.pi], 1e-12),
        ("p", [5, 25], 1e-12),
        ("sq", [2j], 1e-12),
        ("ctp", [1 - 1j, 2 + 3j], 0),        # ctranspose conjugates
    ]),
    ("complex_fft_device", """
zf = gpuArray([1+2i, 3-4i, -2+1i, 0-1i]);
ff = gather(fft(zf));
fi = gather(ifft(fft(zf)));
fr = gather(fft(gpuArray([1 2 3 4 5])));
fm = gather(abs(fft(gpuArray([1+1i; 2-1i; 0+0i]))));
zs = gather(fft(gpuArray(single([1 2 3 4]))));
""", [
        # pinned against MATLAB/numpy fft of [1+2i, 3-4i, -2+1i, 0-1i]
        ("ff", [2 - 2j, 0 - 2j, -4 + 8j, 6 + 4j], 1e-12),
        ("fi", [1 + 2j, 3 - 4j, -2 + 1j, 0 - 1j], 1e-12),
        ("fr", np.fft.fft([1, 2, 3, 4, 5]), 1e-12),
        ("fm", np.abs(np.fft.fft([1 + 1j, 2 - 1j, 0])), 1e-12),
        ("zs", [10, -2 + 2j, -2, -2 - 2j], 1e-5),
    ]),
    ("eig_vd_device", """
A = gpuArray([4 1 0; 1 3 1; 2 1 5]);
[V, D] = eig(A);
r1 = gather(norm(A*V - V*D) / norm(A));
B = gpuArray([0 -2; 1 0]);
[Vb, Db] = eig(B);
r2 = gather(norm(B*Vb - Vb*Db));
di = sort(gather(imag(diag(Db))));
wv = sort(real(gather(eig(A))));
""", [
        ("r1", [0], 1e-10),                  # residual, not a spectrum pin
        ("r2", [0], 1e-10),
        ("di", np.sort([-np.sqrt(2), np.sqrt(2)]), 1e-10),
        ("wv", np.sort(np.linalg.eigvals(
            np.array([[4, 1, 0], [1, 3, 1], [2, 1, 5]], float)).real),
         1e-9),
    ]),
    ("complex_gemm_device", """
Ar = [1 2; 3 4]; Ai = [0 1; -1 2];
Br = [2 0; 1 1]; Bi = [1 -1; 0 2];
Z = gpuArray(Ar + 1i*Ai) * gpuArray(Br + 1i*Bi);
zz = gather(Z);
zs = gather(sum(Z(:)));
""", [
        # expectations compare against the F-order ravel of the gather
        ("zz", ((np.array([[1, 2], [3, 4]]) + 1j * np.array([[0, 1], [-1, 2]]))
                @ (np.array([[2, 0], [1, 1]])
                   + 1j * np.array([[1, -1], [0, 2]]))).ravel(order="F"),
         1e-12),
        ("zs", [((np.array([[1, 2], [3, 4]]) + 1j * np.array([[0, 1], [-1, 2]]))
                 @ (np.array([[2, 0], [1, 1]])
                    + 1j * np.array([[1, -1], [0, 2]]))).sum()], 1e-12),
    ]),
    ("scans_cumulative", """
c1 = gather(cumsum(gpuArray([1 2 3 4])));
c2 = gather(cumsum(gpuArray([1 2; 3 4]), 2));
c3 = gather(cumsum(gpuArray([1 2 3]), 'reverse'));
c4 = gather(cumprod(gpuArray([1 2 3 4])));
c5 = gather(cummax(gpuArray([1 3 2 5 4])));
c6 = gather(cummin(gpuArray([3 1 2 0])));
c7 = gather(cumsum(gpuArray([1 NaN 2]), 'omitnan'));
d1 = gather(diff(gpuArray([1 4 9 16]), 2));
""", [
        ("c1", [1, 3, 6, 10], 0),
        ("c2", [1, 3, 3, 7], 0),
        ("c3", [6, 5, 3], 0),
        ("c4", [1, 2, 6, 24], 0),
        ("c5", [1, 3, 3, 5, 5], 0),
        ("c6", [3, 1, 1, 0], 0),
        ("c7", [1, 1, 3], 0),
        ("d1", [2, 2], 0),
    ]),
    ("transcendentals", """
x = gpuArray([0.5 1.0 2.0]);
e = gather(exp(x));
l = gather(log(x));
s = gather(sin(x)); cs = gather(cos(x)); t = gather(tan(x));
at2 = gather(atan2(gpuArray(1), gpuArray(-1)));
sh = gather(sinh(x)); th = gather(tanh(x));
er = gather(erf(x));
g = gather(gamma(gpuArray(5)));
l1 = gather(log1p(gpuArray(1e-18)));
e1 = gather(expm1(gpuArray(1e-18)));
hp = gather(hypot(gpuArray(3), gpuArray(4)));
""", [
        ("e", np.exp([0.5, 1.0, 2.0]), 1e-6),
        ("l", np.log([0.5, 1.0, 2.0]), 1e-6),
        ("s", np.sin([0.5, 1.0, 2.0]), 1e-6),
        ("cs", np.cos([0.5, 1.0, 2.0]), 1e-6),
        ("t", np.tan([0.5, 1.0, 2.0]), 1e-6),
        # measured on v5e: double atan2 carries ~6e-8 error (f64 on TPU is
        # emulated with f32 pairs; transcendental lowerings bottom out in
        # f32 approximations) — the bound is pinned so a REGRESSION beyond
        # the platform's documented envelope still fails
        ("at2", [3 * np.pi / 4], 5e-7),
        ("sh", np.sinh([0.5, 1.0, 2.0]), 1e-6),
        ("th", np.tanh([0.5, 1.0, 2.0]), 1e-6),
        ("er", [0.5204998778130465, 0.8427007929497149,
                0.9953222650189527], 1e-6),
        ("g", [24], 1e-6),
        # 1+1e-18 rounds to 1.0 in f64, so a naive log(1+x)/exp(x)-1 would
        # return 0 — these pin the compensated small-x paths
        ("l1", [1e-18], 1e-20),
        ("e1", [1e-18], 1e-20),
        ("hp", [5], 1e-12),
    ]),
    ("linalg_small", """
A = gpuArray([4 2; 2 3]);
x = gather(A \\ [8; 7]);
d = gather(det(A));
iv = gather(inv(A));
[R, pflag] = chol(gpuArray([2 0; 0 3]));
R = gather(R); pflag = gather(pflag);
[Rbad, pbad] = chol(gpuArray([1 2; 2 1]));
pbad = gather(pbad);
rbsz = size(Rbad);
rb1 = Rbad(1, 1);
nrm = gather(norm(gpuArray([3 4])));
n1 = gather(norm(gpuArray([1 -2; 3 -4]), 1));
ninf = gather(norm(gpuArray([1 -2; 3 -4]), inf));
tA = gather(trace(A));
r = gather(rank(gpuArray([1 2; 2 4])));
""", [
        ("x", [1.25, 1.5], 1e-6),
        ("d", [8], 1e-6),
        ("iv", [0.375, -0.25, -0.25, 0.5], 1e-6),
        ("R", [np.sqrt(2), 0, 0, np.sqrt(3)], 1e-6),
        ("pflag", [0], 0),
        # [R,p] = chol(non-PD): p = failing 1-based pivot, R = successful
        # (p-1)x(p-1) leading factor with R'*R == A(1:p-1,1:p-1)
        ("pbad", [2], 0),
        ("rbsz", [1, 1], 0),
        ("rb1", [1], 1e-12),
        ("nrm", [5], 1e-6),
        ("n1", [6], 1e-6),                   # max column abs sum
        ("ninf", [7], 1e-6),                 # max row abs sum
        ("tA", [7], 0),
        ("r", [1], 0),
    ]),
    ("histcounts_interp", """
h = gather(histcounts(gpuArray([0.1 0.5 0.5 0.9 1.0]), [0 0.5 1.0]));
h2 = gather(histcounts(gpuArray([NaN -1 0.2 2]), [0 1]));
iq = gather(interp1([1 2 3], [10 20 30], gpuArray([1.5 2.5])));
ix = gather(interp1([1 2 3], [10 20 30], gpuArray(4)));
""", [
        ("h", [1, 4], 0),                    # last bin right-closed
        ("h2", [1], 0),                      # NaN and out-of-range drop
        ("iq", [15, 25], 1e-9),
        ("ix", [np.nan], 0),                 # extrapolation -> NaN default
    ]),
    ("find_logic", """
v = gpuArray([0 3 0 7 5]);
f1 = gather(find(v));
f2 = gather(find(v, 2));
fl = gather(find(v, 1, 'last'));
ay = gather(any(gpuArray([0 0 1])));
al = gather(all(gpuArray([1 0 1])));
nz = gather(nnz(v));
sg = gather(sign(gpuArray([-3 0 2])));
xr = gather(xor(gpuArray([1 1 0]), gpuArray([1 0 0])));
""", [
        ("f1", [2, 4, 5], 0),
        ("f2", [2, 4], 0),
        ("fl", [5], 0),
        ("ay", [1], 0),
        ("al", [0], 0),
        ("nz", [3], 0),
        ("sg", [-1, 0, 1], 0),
        ("xr", [0, 1, 0], 0),
    ]),
    ("minmax_k_options", """
[mv, mi] = max(gpuArray([3 1 3 2]));
mv = gather(mv); mi = gather(mi);
[sv, si] = sort(gpuArray([3 1 2]), 'descend');
sv = gather(sv); si = gather(si);
mk = gather(maxk(gpuArray([5 1 9 3 7]), 2));
nk = gather(mink(gpuArray([5 1 9 3 7]), 2));
[la, li] = max(gpuArray([2 8; 6 4]), [], 'all', 'linear');
la = gather(la); li = gather(li);
""", [
        ("mv", [3], 0),
        ("mi", [1], 0),                      # first occurrence wins
        ("sv", [3, 2, 1], 0),
        ("si", [1, 3, 2], 0),
        ("mk", [9, 7], 0),
        ("nk", [1, 3], 0),
        ("la", [8], 0),
        ("li", [3], 0),                      # column-major linear index
    ]),
    ("rng_determinism", """
rng(99);
a = gather(gpuArray(rand(1, 4)));
rng(99);
b = gather(gpuArray(rand(1, 4)));
rng(99, 'twister');
c = rand(1, 4);
eqd = max(abs(a - b));
eqh = max(abs(a - c));
""", [
        ("eqd", [0], 0),                     # device RNG reproducible
        # device f64 is a 2xf32 emulation (~49-bit mantissa): the Threefry
        # BITS are identical but the bits->double conversion can differ
        # from the host by a few last-place bits (measured 8.9e-16 over
        # 1000 draws on v5e); pin the envelope, not exactness
        ("eqh", [0], 4e-15),                 # device ~= host stream
    ]),
    ("matmul_policy_f32", """
rng(42);
A = single(rand(256)); B = single(rand(256));
C = gather(gpuArray(A) * gpuArray(B));
Ch = A * B;
err = double(max(abs(C(:) - Ch(:))) / max(abs(Ch(:))));
""", [
        # parity default (highest): f32-rounding-level agreement; the bf16
        # downcast would show ~1e-3 and fail this gate
        ("err", [0], 2e-6),
    ]),
    ("empty_semantics", """
e = [];
se = gather(sum(gpuArray(e)));
pe = gather(prod(gpuArray(e)));
me = gather(max(gpuArray(e)));
sz = size(gpuArray(zeros(0, 3)));
ce = gather(cumsum(gpuArray(e)));
ne = gather(norm(gpuArray(e)));
""", [
        ("se", [0], 0),                      # sum([]) == 0
        ("pe", [1], 0),                      # prod([]) == 1
        ("me", [], 0),                       # max([]) == []
        ("sz", [0, 3], 0),
        ("ce", [], 0),
        ("ne", [0], 0),
    ]),
    ("special_values", """
iv = gather(gpuArray(1) / 0);
nv = gather(gpuArray(0) / 0);
lz = gather(log(gpuArray(0)));
p0 = gather(gpuArray(0) ^ 0);
ip = gather(isinf(gpuArray([Inf -Inf NaN 1])));
nn = gather(isnan(gpuArray([Inf NaN 1])));
mxi = gather(max(gpuArray([-Inf 3])));
ee = gather(exp(gpuArray(-Inf)));
""", [
        ("iv", [np.inf], 0),
        ("nv", [np.nan], 0),
        ("lz", [-np.inf], 0),
        ("p0", [1], 0),
        ("ip", [1, 1, 0, 0], 0),
        ("nn", [0, 1, 0], 0),
        ("mxi", [3], 0),
        ("ee", [0], 0),
    ]),
    ("single_precision_class", """
s = gpuArray(single(1)) + 1;
cls = class(gather(s));
eps1 = gather(eps(gpuArray(single(1))));
big = gather(single(1e10) + gpuArray(single(1)));
ov = gather(single(1e39) * gpuArray(single(10)));
""", [
        ("eps1", [float(np.finfo(np.float32).eps)], 0),
        ("big", [np.float32(1e10)], 0),      # absorbed at f32 precision
        ("ov", [np.inf], 0),                 # f32 overflow -> Inf, no wrap
    ]),
    ("reshape_indexing", """
M = gpuArray(reshape(1:12, 3, 4));
c = gather(M(:, 2));
r = gather(M(2, :));
lin = gather(M(5));
lg = gather(M(M > 9));
pm = gather(permute(M, [2 1]));
fl2 = gather(flip(M, 2));
M(2, 2) = 99;
asn = gather(M(2, 2));
ed = gather(M(:, end));
""", [
        ("c", [4, 5, 6], 0),
        ("r", [2, 5, 8, 11], 0),
        ("lin", [5], 0),                     # column-major linear indexing
        ("lg", [10, 11, 12], 0),
        ("pm", [1, 4, 7, 10, 2, 5, 8, 11, 3, 6, 9, 12], 0),
        ("fl2", [10, 11, 12, 7, 8, 9, 4, 5, 6, 1, 2, 3], 0),
        ("asn", [99], 0),
        ("ed", [10, 11, 12], 0),
    ]),
]


def _cmp(got: np.ndarray, want, tol: float) -> bool:
    g = np.asarray(got).reshape(-1, order="F")
    w = np.asarray(want).reshape(-1)
    if g.shape[0] != w.shape[0]:
        return False
    if w.shape[0] == 0:
        return True
    if np.iscomplexobj(g) and not np.iscomplexobj(w):
        if np.any(g.imag != 0):
            return False
        g = g.real
    w = w.astype(np.complex128 if np.iscomplexobj(w) else np.float64)
    g = g.astype(w.dtype)
    nan_w = np.isnan(w) if not np.iscomplexobj(w) else np.isnan(w.real)
    nan_g = np.isnan(g) if not np.iscomplexobj(g) else np.isnan(g.real)
    if not np.array_equal(nan_w, nan_g):
        return False
    m = ~nan_w
    if tol == 0:
        return bool(np.all(g[m] == w[m]))
    return bool(np.all(np.abs(g[m] - w[m]) <= tol * np.maximum(
        1.0, np.abs(w[m]))))


def run(sess) -> dict:
    """Execute the battery through `sess`; returns {"passed": n, "failed":
    n, "cases": n, "seconds": s, "failures": [...]}. A program that errors
    fails all its checks; every check is counted, none is skipped."""
    import time
    t0 = time.perf_counter()
    passed = failed = 0
    failures = []
    for name, src, checks in CASES:
        try:
            r = sess.execute(src)
            err = r.error
        except Exception as e:   # a Python error of the port is a failure
            err = e
        if err is not None:
            failed += len(checks)
            failures.append(f"{name}: program error: "
                            f"{type(err).__name__}: {err}")
            continue
        for var, want, tol in checks:
            try:
                v = sess.get(var)
                got = v.host() if hasattr(v, "host") else np.asarray(v)
                if _cmp(got, want, tol):
                    passed += 1
                else:
                    failed += 1
                    failures.append(
                        f"{name}.{var}: got "
                        f"{np.asarray(got).reshape(-1, order='F')[:8]} want "
                        f"{np.asarray(want).reshape(-1)[:8]}")
            except Exception as e:
                failed += 1
                failures.append(f"{name}.{var}: {type(e).__name__}: {e}")
    return {"passed": passed, "failed": failed, "cases": len(CASES),
            "seconds": time.perf_counter() - t0, "failures": failures}

