"""The port's copied host layers against the JAX package's, snippet by snippet.

Each snippet runs through `runmat_tpu.session.Session(accelerate=False)`,
the port's `Session(accelerate=False)` and the port's session on
`TorchEngine("cpu")` (its default policy offloads nothing on the CPU, so
the host layers do the work). The printed output and the error are held
equal as text; workspace arrays are compared through numpy, class and
shape exactly, values exactly (tolerance 0) or, where a snippet says so,
within a relative 1e-6 (f32 reductions); other values by their display
text. Each of the builtin modules the port carries is reached by at least
one snippet, and so are if/for/while, indexing and fprintf formatting.
"""

import re

import pytest

from runmat_tpu_torch.parity_snippets import SNIPPETS as MODULE_SNIPPETS

from torch_both import EXACT, host_parity, no_engine  # noqa: F401

F32_REDUCTION = 1e-6   # sums of f32 values in another order

# (id, source, tolerance)
SNIPPETS = [
    ("elementwise", "x = [1.5 -2 3]; y = abs(x) + sqrt(4) .* sin(x);"
                    " z = floor(-2.5) + round(2.5) + fix(-1.7) + sign(-3);",
     EXACT),
    ("elementwise-single", "a = single([0.5 2 4]); b = exp(a) - log(a);"
                           " c = a .^ 2 ./ (a + 1);", EXACT),
    ("elementwise-logical", "a = [1 0 2] & [1 1 0]; b = ~[1 0]; "
                            "d = mod(-7, 3); e = rem(-7, 3); f = [1 2] == 2;",
     EXACT),
    ("integers", "a = int8(100) + int8(100); b = uint8(5) - uint8(10);"
                 " c = int32(7) / int32(2); d = class(a);", EXACT),
    ("creation", "z = zeros(2, 3); o = ones(3, 1, 'single'); e = eye(3);"
                 " l = linspace(0, 1, 5); t = true(2); r = repmat([1 2], 2, 2);",
     EXACT),
    ("creation-colon", "c = 1:3:10; d = 10:-2:1; e = colon(1, 4);", EXACT),
    ("reductions", "A = reshape(1:12, 3, 4); s = sum(A); m = mean(A, 2);"
                   " mx = max(A(:)); [mn, i] = min([4 2 8]); p = prod([1 2 3 4]);",
     EXACT),
    ("reductions-f32", "x = single(linspace(0, 1, 1000)); s = sum(x);"
                       " m = mean(x); v = var(x); sd = std(x);", F32_REDUCTION),
    ("reductions-nan", "x = [1 NaN 3]; a = sum(x); b = sum(x, 'omitnan');"
                       " c = max(x); d = mean(x, 'omitnan'); n = nnz(x);",
     EXACT),
    ("scans", "c = cumsum([1 2 3; 4 5 6], 2); p = cumprod([1 2 3]);"
              " m = cummax([1 3 2 5]);", EXACT),
    ("arrays", "A = reshape(1:16, 4, 4); B = A'; C = reshape(A, 2, 8);"
               " d = diff([1 4 9 16]); f = flip([1 2 3]);"
               " k = find([0 1 0 1]); h = horzcat([1 2], 3);", EXACT),
    ("arrays-size", "[r, c] = size(ones(3, 5)); n = numel(ones(2, 3));"
                    " e = isempty([]); s = circshift([1 2 3 4], 1);", EXACT),
    ("rng", "rng(5); a = rand(3); b = randn(2, 2); c = randi(10, 1, 5);",
     EXACT),
    ("rng-single", "rng(1); x = rand(1, 1000, 'single'); s = sum(x);",
     F32_REDUCTION),
    ("stats", "h = histcounts([1 2 2 3 3 3 4], [0 1 2 3 4]);"
              " mm = movmean(1:10, 3); q = histcounts([2 4 4 5 7 9], 4);"
              " t = trapz([1 2 3]);", EXACT),
    ("gpu", "y = gather([1 2 3]) * 2; t = isgpuarray(y);", EXACT),
    ("io-fprintf", "fprintf('%d apples and %.3f pears\\n', 3, pi);"
                   " fprintf('%d,%d\\n', [1 2; 3 4]); disp([1 2; 3 4]);",
     EXACT),
    ("io-display", "x = 5\nA = [1.5 2; 3 4]\ns = 'text'", EXACT),
    ("strings", "s = sprintf('%5.2f|', [1.234 5.678]); t = upper('abc');"
                " n = num2str(42); c = strcat('a', 'b');"
                " u = strrep('hello world', 'o', '0');", EXACT),
    ("strings-split", "parts = strsplit('a,b,c', ','); j = strjoin(parts, '-');",
     EXACT),
    ("introspection", "c = class(single(1)); b = isa(1, 'double');"
                      " n = isnumeric('a'); l = islogical(true);", EXACT),
    ("control", "t = isequal([1 2], [1 2]);"
                " try, error('my:id', 'boom %d', 3);"
                " catch err, msg = err.message; id = err.identifier; end",
     EXACT),
    ("if", "x = 3; if x > 2, y = 1; elseif x > 1, y = 2; else, y = 3; end",
     EXACT),
    ("for-long", "acc = 0; for k = 1:10, acc = acc + k^2; end", EXACT),
    ("for-grow", "v = []; for k = 1:3, v(end+1) = k * 2; end", EXACT),
    ("while", "n = 0; k = 1; while k < 100, k = k * 3; n = n + 1; end",
     EXACT),
    ("indexing", "A = reshape(1:25, 5, 5); b = A(2:3, [1 5]);"
                 " A(1, :) = 0; c = A(end, end); A(:, 2) = [];", EXACT),
    ("indexing-logical", "x = 1:10; y = x(x > 5); x(x < 3) = -1;", EXACT),
    ("functions", "f = @(t) t.^2 + 1; y = f(3);"
                  " g = arrayfun(@(v) v * 2, [1 2 3]);", EXACT),
    ("cells-structs", "s.a = 1; s.b = 'text'; c = {1, 'two', [3 4]};"
                      " n = numel(c); w = c{3};", EXACT),
    ("undefined", "y = no_such_function(3);", EXACT),
    ("cellfun", "c = cellfun(@numel, {[1 2], 'abc', []});"
                " d = cellfun(@(v) v * 2, {1, 2}, 'UniformOutput', false);"
                " n = num2cell([1 2 3]); s.a = 1; s.b = 'x';"
                " v = struct2cell(s); m = cell2mat({[1 2], [3]});", EXACT),
    ("logical-ops", "a = xor([1 0 1], [1 1 0]); b = bitand(uint8(12), 10);"
                    " c = bitor(5, 3); d = bitshift(1, 4);", EXACT),
    ("handles", "f = str2func('@(x) x + 1'); y = f(2); s = func2str(f);"
                " g = func2str(@sin); h = str2func('cos'); z = h(0);", EXACT),
    ("sets-sort", "[s, i] = sort([3 NaN 1 2 1 -0 0], 'descend');"
                  " [a, j] = sort([2; NaN; 1]); [u, ia, ic] = unique([4 2 4 9 2]);"
                  " us = unique([3 1 3 NaN 2 NaN], 'stable');"
                  " tf = ismember([1 5 2 NaN], [2 3 NaN]); un = union([3 1], [2 1]);"
                  " in = intersect([5 1 3 3], [3 5 8]); d = setdiff([5 1 3], 3);"
                  " x = setxor([NaN 1 2], [2 3]);", EXACT),
    ("linalg", "A = [4 1 0; 1 3 1; 0 1 2]; R = chol(A); x = A \\ [1; 2; 3];"
               " d = det(A); Ai = inv(A); [Q, Rq] = qr(A); s = svd(A);"
               " e = eig(A); [L, U, P] = lu(A); n = norm(A); r = rank(A);"
               " t = trace(A); c = cond(A); p = pinv([1 2; 3 4; 5 6]);"
               " [R2, k] = chol([1 2; 2 1]);", EXACT),
    ("linalg-errors", "chol([1 2; 2 1]);", EXACT),
    ("fft-signal", "x = sin(0.3*(1:16)); f = fft(x); g = real(ifft(f));"
                   " F = fft2(reshape(1:16, 4, 4)); sh = fftshift(1:5);"
                   " y = filter([1 2 1]/4, [1 -0.5], x); c = conv(x, [1 -1]);"
                   " c2 = conv2(reshape(1:16, 4, 4), ones(2)); w = hann(8); h = abs(hilbert(x));"
                   " v = envelope(x); s = sinc(0.5);", EXACT),
]
# the builtin modules copied in the interpolation, selection and page slice
# (interp_poly, breadth2-4, linalg2, ...), one snippet each, shared with
# chip_smoke.py, which runs them on a card
SNIPPETS += [(sid, src, tol) for sid, _, src, tol in MODULE_SNIPPETS]


@pytest.mark.parametrize("sid,src,tol", SNIPPETS,
                         ids=[s[0] for s in SNIPPETS])
def test_snippet_matches_the_jax_host_path(no_engine, sid, src, tol):
    host_parity(sid, src, tol)


def test_every_carried_builtin_module_is_reached():
    # each snippet's builtins resolve through the port's registry; the
    # modules they come from cover every builtin module the port carries
    # that registers a name
    from runmat_tpu_torch.runtime import registry
    registry.ensure_loaded()
    modules = {b.fn.__module__.rsplit(".", 1)[1]
               for b in registry.all_builtins().values()}
    called = set()
    for _, src, _ in SNIPPETS:
        for name in set(re.findall(r"[A-Za-z_]\w*", src)):
            b = registry.lookup(name)
            if b is not None:
                called.add(b.fn.__module__.rsplit(".", 1)[1])
    assert modules <= called, modules - called
