% Distribution check of a Monte Carlo sample: histograms of uniform and
% normal draws against their densities, the empirical CDF and a chi-square
% statistic, as one validates a random-number generator or a simulation's
% output. Runs on the device through histcounts, cumsum, movmean, trapz and
% diff. Set N (sample size) and seed before running to change them.
if ~exist('seed', 'var'), seed = 0; end
rng(seed);
if ~exist('N', 'var'), N = 2^26; end
u = rand(N, 1, 'single');
z = randn(N, 1, 'single');
cu = histcounts(u, single(0:1/128:1));             % affine edges, f32: direct-index mode
ez = single(-4:0.1:4);
cz = histcounts(z, ez);                            % 80 arbitrary edges, f32: search mode
cq = histcounts(z .* z, [0 0.25 0.5 1 2 4 8 16]);  % double edges -> f64: search mode
pz = cz / (N * 0.1);
Fz = cumsum(cz) / N;
sm = movmean(pz, 5);
area = trapz(pz) * 0.1;
dF = diff(Fz);
chi2 = sum((cu - N / 128) .^ 2) / (N / 128);
res = gather(chi2 + area + max(abs(dF * 10 - pz(2:end))) + sum(cq) / N + sum(sm));
fprintf('RESULT_ok HIST=%.6e\n', double(res));
