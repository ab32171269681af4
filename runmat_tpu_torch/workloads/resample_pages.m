% A sensor record resampled onto a warped time grid, as a test or
% vibration engineer realigns a channel: its largest excursions and lowest
% values picked, a stretch smoothed by a long recursive filter, and a
% batch of small dense systems of the kind a state-space or element code
% carries, multiplied, solved, inverted and measured page by page. The
% data are made on the device. Set N (the record's length), P (the pages)
% and seed before running.
if ~exist('seed', 'var'), seed = 0; end
rng(seed);
if ~exist('N', 'var'), N = 2^22; end
if ~exist('P', 'var'), P = 8192; end
t = linspace(0, 1, N)';
x = sin(2*pi*50*t) + 0.1*randn(N, 1);
tq = linspace(0, 1, N)' .^ 1.5;                    % warped time grid
y = interp1(t, x, tq);                             % interp1lin
top = maxk(abs(y), 1024);                          % topk
low = mink(y, 16);                                 % topk
w = filter(ones(1, 40) / 40, [1 0.01*ones(1, 39)], y(1:min(N, 2^18)));  % order 39
A = randn(32, 32, P) + 32*eye(32);                 % P pages of 32 x 32
B = randn(32, 32, P);
C = pagemtimes(A, B);
D = pagefun(@mtimes, A, B);
E = pagemtimes(A, 'transpose', B, 'none');
X = pagemldivide(A, B);
Ai = pageinv(A);
nC = pagenorm(C, 'fro');
res = gather(mean(y) + sum(top) / 1024 + sum(low) / 16 + mean(w) + ...
             sum(nC(:)) / P + sum(C(:)) / P + sum(D(:)) / P + ...
             sum(E(:)) / P + sum(X(:)) / P + sum(Ai(:)) / P);
fprintf('RESULT_ok PAGES=%.12e\n', double(res));
