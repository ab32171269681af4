% A sparse Poisson solve on one card, as a MATLAB user writes it: the
% five-point stencil on an N x N grid as a sparse matrix from spdiags, a
% smooth right side, and x = A\b, which for a symmetric A with more than
% 2048 unknowns runs Jacobi-preconditioned conjugate gradient on the device
% (tolerance 1e-10 of norm(b)). Set N before running.
if ~exist('N', 'var'), N = 1024; end
n = N^2;
e = ones(n, 1);
A = spdiags([-e -e 4*e -e -e], [-N -1 0 1 N], n, n);
b = (1 + sin((1:n)' * pi / N)) / (N + 1)^2;
x = A \ b;
fprintf('x(1) = %.12e, x(n/2) = %.12e, x(n) = %.12e\n', x(1), x(n/2), x(n));
fprintf('RESULT_ok POISSON=%.12e\n', sum(x));
