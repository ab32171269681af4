% A 1080p field, measured or simulated, smoothed and saved as a heat map,
% as an engineer does before a review. On the device: the field is drawn,
% smoothed with a 15 x 15 Gaussian (imfilter with the edge replicated) and
% colormapped for imagesc, so one byte a channel comes back and not the
% float64 field. On the host: a second figure with one row's profile
% before and after smoothing, the heat map printed to a PNG and saved as
% an SVG under tempname and deleted, and the device named by gpuInfo.
% Set H (rows), W (columns) and seed before running.
if ~exist('seed', 'var'), seed = 0; end
rng(seed);
if ~exist('H', 'var'), H = 1080; end
if ~exist('W', 'var'), W = 1920; end
X = randn(H, W);                                   % normal draw, f64
K = fspecial('gaussian', 15, 3);
Y = imfilter(X, K, 'replicate');                   % correlation on the device
f1 = figure;
imagesc(Y);                                        % colormapped on the device
colormap('parula');
colorbar;
title('smoothed field');
f2 = figure;
row = round(H / 2);
plot(1:W, Y(row, :));
hold on;
plot(1:W, X(row, :), 'r:');
hold off;
xlabel('column');
ylabel('value');
base = tempname;
png = [base '.png'];
svg = [base '.svg'];
figure(f1);
print('-dpng', png);
saveas(gcf, svg);
png_ok = exist(png, 'file') == 2;
svg_ok = exist(svg, 'file') == 2;
delete(png);
delete(svg);
g = gpuInfo();
fprintf('RESULT_ok FIELD=%.17g\n', std(Y(:)));
