% One long recording at 48 kHz, as an audio or vibration analyst runs it:
% a two-tone signal in noise, a 31-tap windowed-sinc FIR and a 4th-order
% Butterworth IIR filter, its spectrum and power, a band-pass by spectral
% masking, the envelope of the band, a spectrogram of the first part, a
% direct convolution, and a single-precision 5x5 box blur of the record
% laid out as an image. The data are made on the device. Set N (a power
% of 4, at least 4096) and seed before running.
if ~exist('seed', 'var'), seed = 0; end
rng(seed);
if ~exist('N', 'var'), N = 2^22; end
fs = 48000;
t = linspace(0, (N - 1) / fs, N)';
x = sin(2*pi*1000*t) + 0.5*sin(2*pi*5000*t) + 0.1*randn(N, 1);
k = -15:15;
b = sinc(0.25 * k) .* hamming(31)';                % 31-tap windowed sinc
b = b / sum(b);
y = filter(b, 1, x);                               % fir
bb = [0.00041659920440659937 0.0016663968176263975 0.0024995952264395961 ...
      0.0016663968176263975 0.00041659920440659937];   % butter(4, 0.1)
aa = [1 -3.1806385488747191 3.8611943489942133 -2.1121553551109691 ...
      0.43826514226197977];
z = filter(bb, aa, x);                             % iir
X = fft(y);                                        % complex spectrum
P = abs(X) .^ 2 / N;                               % power
fk = linspace(0, fs * (N - 1) / N, N)';
fk = min(fk, fs - fk);                             % folded frequency
H = (fk > 500) & (fk < 2000);                      % band mask
yb = real(ifft(X .* H));                           % band-passed signal
env = envelope(yb);                                % hilbert, envelope mode
Ns = min(N, 2^18);
S = spectrogram(x(1:Ns), hann(1024), 512, 1024);   % returned on the host
s1k = abs(S(22, :));                               % the 1 kHz bin over time
c = conv(y(1:min(N, 65536)), b);                   % conv1
Ng = min(N, 2^20);
q = round(sqrt(Ng));
G = conv2(single(reshape(y(1:Ng), q, q)), single(ones(5) / 25), 'same');
res = gather(sum(P) / N^2 + mean(z .^ 2) + mean(yb .^ 2) + mean(env) + ...
             sum(c) / numel(c)) + mean(s1k) / 512;
fprintf('RESULT_ok SPECTRAL=%.12e\n', double(res));
