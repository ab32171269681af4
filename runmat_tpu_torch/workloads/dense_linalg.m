% Dense linear algebra on one card, as a MATLAB user runs it: a random
% matrix and its symmetric positive definite Gram matrix, factored and
% solved, with each factorization's residual, the spectra of both, and the
% small-block builtins (inv, det, cond, rank, pinv, trace). Set N (a
% multiple of 16) and seed before running.
if ~exist('seed', 'var'), seed = 0; end
rng(seed);
if ~exist('N', 'var'), N = 4096; end
A = randn(N, N);
S = A' * A / N;
S = (S + S') / 2;                                  % exactly symmetric
S(1:N+1:end) = S(1:N+1:end) + 1;                   % + eye(N), on the device
b = randn(N, 1);
R = chol(S);                                       % chol
res_chol = norm(R' * R - S, 'fro') / norm(S, 'fro');
x = S \ b;                                         % solve (mldivide)
res_solve = norm(S * x - b) / norm(b);             % norm
Aq = A(:, 1:N/4);
[Q, Rq] = qr(Aq, 0);                               % economy qr
res_qr = norm(Q * Rq - Aq, 'fro') / norm(Aq, 'fro');
s = svd(A(1:N/2, 1:N/2));                          % singular values
e = eig(S);                                        % ishermitian, eigh
w = eig(A(1:N/8, 1:N/8));                          % eig_qr: a complex spectrum
Al = A(1:N/2, 1:N/2);
[L, U, P] = lu(Al);                                % lu
res_lu = norm(P * Al - L * U, 'fro') / norm(Al, 'fro');
Sb = S(1:N/4, 1:N/4);
bb = b(1:N/4);
Si = inv(Sb);                                      % inv
res_inv = norm(Sb * (Si * bb) - bb) / norm(bb);
d = det(S(1:N/16, 1:N/16));                        % det
c = cond(S(1:N/8, 1:N/8));                         % cond (its host path)
r = rank(A(1:N/8, 1:N/8));                         % rank
Ap = A(1:N/8, 1:N/16);
Pp = pinv(Ap);                                     % pinv
res_pinv = norm(Ap * (Pp * Ap) - Ap, 'fro') / norm(Ap, 'fro');
tr = trace(S);                                     % trace
res = gather(sum(s) / N + sum(e) / N + sum(real(w)) / N + log(d) / N + ...
             c / N + r / N + tr / N + sum(x .* b) / N);
fprintf('RESULT_ok LINALG=%.12e\n', double(res));
