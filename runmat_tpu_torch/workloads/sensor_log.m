% A month of 1 Hz readings from a plant's sensors, summarised per day as a
% monitoring or test engineer does. On the device: the readings are drawn,
% given a daily cycle, reduced to each day's mean, spread and peak, and
% binned into histograms in double and in single precision. On the host:
% the days as datetime values with their business-day flags, a table of
% the daily statistics sorted by peak, a timetable resampled to weekly
% means, a CSV written and read back, a MAT file saved and loaded, and a
% short report written with fprintf and read back; the files go under
% tempname and are deleted. Set D (days), F (samples a day), C (channels)
% and seed before running.
if ~exist('seed', 'var'), seed = 0; end
rng(seed);
if ~exist('D', 'var'), D = 30; end
if ~exist('F', 'var'), F = 86400; end
if ~exist('C', 'var'), C = 8; end
x = randn(F*D, C);                                 % normal draw, f64
tday = linspace(0, D - 1/F, F*D)';                 % time in days
x = x + 2*sin(2*pi*tday);                          % the daily cycle
R = reshape(x, F, D, C);
mu = reshape(mean(R, 1), D, C);
sd = reshape(std(R, 0, 1), D, C);
mx = reshape(max(R, [], 1), D, C);
e = -8:0.25:8;
n64 = histcounts(x, e);                            % sorted edges, f64: search mode
n32 = histcounts(single(x), single(e));            % power-of-two edges, f32: direct mode
day = datetime(2026, 1, 1) + days(0:D-1)';
bus = isbusday(day);
T = array2table([mu sd mx]);
T = addvars(T, double(bus), 'NewVariableNames', {'Busy'});
Ts = sortrows(T, 2*C + 1, 'descend');              % the day with the highest peak first
TT = table2timetable(T, 'RowTimes', day);
W = retime(TT, 'weekly', 'mean');
base = tempname;
fcsv = [base '.csv'];
writetable(Ts, fcsv);
Rt = readtable(fcsv);
csv_ok = isequal(table2array(Rt), table2array(Ts));
fmat = [base '.mat'];
save(fmat, 'mu', 'sd', 'mx', 'n64', 'n32');
L = load(fmat);
mat_ok = isequal(L.mu, mu) && isequal(L.sd, sd) && isequal(L.mx, mx) && ...
         isequal(L.n64, n64) && isequal(L.n32, n32);
frep = [base '.txt'];
fid = fopen(frep, 'w');
fprintf(fid, 'sensor log: %d days, %d channels, %d business days\n', D, C, sum(bus));
top = table2array(Ts(1, :));
fprintf(fid, 'peak %.6f on %s\n', top(2*C + 1), datestr(day(find(mx(:, 1) == top(2*C + 1), 1))));
fprintf(fid, 'weeks %d, first weekly mean %.6f\n', height(W), W.Var1(1));
fclose(fid);
txt = fileread(frep);
delete(fcsv); delete(fmat); delete(frep);
res = sum(mu(:)) + sum(sd(:)) / C + sum(mx(:)) / (D*C) + ...
      sum(n64 .* (1:64)) / (F*D) + sum(double(n32)) / (F*D) + sum(W.Var1) + ...
      csv_ok + mat_ok + height(W) + numel(txt);
fprintf('RESULT_ok SENSOR=%.12e\n', double(res));
