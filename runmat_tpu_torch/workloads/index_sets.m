% Cleaning and ranking a large sample on the device, as one prepares a
% simulation or sensor record: outliers clipped through a mask, a strided
% subset overwritten, half the columns negated, the record flipped, shifted
% and permuted, a loop of per-column writes, a sort with its permutation,
% distinct levels with their counts, set operations against reference
% levels, and a Newton iteration run to a tolerance. Set N (a multiple of
% 65536) and seed before running.
if ~exist('seed', 'var'), seed = 0; end
rng(seed);
if ~exist('N', 'var'), N = 2^26; end
C = N / 4096;
x = randn(N, 1, 'single');
x(abs(x) > 3) = 3;                                  % maskset, device mask
x(1:64:N) = 0;                                      % scatter1, host subscripts
A = reshape(x, 4096, C);
A(:, 2:2:C) = -A(:, 2:2:C);                         % gatherN + scatterN
B = circshift(flip(A, 1), 7, 2);                    % flipL, rollL
P = permute(reshape(A(:, 1:8), 64, 64, 8), [3 1 2]);   % permuteL
L = tril(A(1:16, 1:16)) + triu(A(1:16, 1:16), 1)';  % trilL, triuL
R = repmat(A(1:4, 1:4), 2, 3);                      % tileL
for k = 1:16                                        % folded: dynamic gatherN/scatterN
  B(:, k) = B(:, k) * k;
end
[s, i] = sort(x, 'descend');
med = median(x);
q = round(x * 8);
[u, ia, ic] = unique(q);
cnt = accumarray(ic, ones(N, 1, 'single'), [numel(u) 1]);
mo = mode(q);
lv = single(-8:2:8);
both = intersect(u, lv); only = setdiff(u, lv); un = union(u, lv);
tf = ismember(q, lv);
a = abs(s(1:1024:N)) + 1;                           % gather1, host subscripts
y = a; err = max(abs(y .* y - a));
while err > 1e-4                                    % folded while
  y = 0.5 * (y + a ./ y);
  err = max(abs(y .* y - a));
end
res = gather(sum(s(1:1000)) + med + numel(u) + sum(cnt) / N + mo ...
    + numel(both) + numel(only) + numel(un) + sum(tf) / N + sum(y) / numel(y) ...
    + sum(P, 'all') / N + sum(L, 'all') + sum(R, 'all') + sum(B(:, 1:16), 'all') / N ...
    + double(i(1)) / N + sum(ia(1:4)) / N);
fprintf('RESULT_ok RANK=%.6e\n', double(res));
