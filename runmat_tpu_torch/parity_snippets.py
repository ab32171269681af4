"""MATLAB snippets that reach the builtin modules the port copied last.

Each entry is (id, module, source, tolerance): `source` calls builtins
that `module` (runmat_tpu_torch/runtime/builtins/<module>.py) registers,
at small sizes, with the data made in the snippet. `tests/test_torch_parity.py`
runs each through the JAX package's host session and the port's (their
output, errors and workspaces equal: exactly where the tolerance is 0,
else within that relative tolerance), and `chip_smoke.py` runs each in a
card session against the port's host engine. `NEEDS` names the Python
package a snippet's module imports lazily where the card machine may not
have it.
"""

EXACT = 0.0
# a network's float32 outputs and learnables: sums in another order (the
# CPU's BLAS, cuBLAS, cuDNN) and three Adam steps
DL_FLOAT32 = 1e-5

SNIPPETS = [
    ("linalg2", "linalg2",
     "v = vecnorm([3 4; 0 5]); A = reshape(1:8, 2, 2, 2);"
     " C = pagemtimes(A, A); T = pagetranspose(A);"
     " Ai = pageinv(A + 3*eye(2)); X = pagemldivide(A + 3*eye(2), A);"
     " nf = pagenorm(A, 'fro'); n1 = pagenorm(A, 1); Ct = pagectranspose(A);"
     " D = pagefun(@mtimes, A, A); R = rref([1 2 3; 4 5 6]);"
     " e = eigs([2 1 0; 1 3 1; 0 1 4], 2); s = svds([1 2; 3 4; 5 6], 1);"
     " c = condest([4 1; 2 3]); p = symrcm([1 1 0; 1 1 1; 0 1 1]);"
     " t = tensorprod([1 2; 3 4], [5 6; 7 8], 2, 1); m = mpower([1 1; 0 1], 3);",
     EXACT),
    ("interp-poly", "interp_poly",
     "y = interp1([1 2 3], [4 5 9], [1.5 2.5 3 0]);"
     " yn = interp1([1 2 3], [4 5 9], [1.2 2.7], 'nearest');"
     " ys = spline(1:4, [1 8 27 64], 2.5); yp = pchip(1:4, [1 8 27 64], [1.5 3.5]);"
     " d = polyder([1 2 3]); i = polyint([3 2 1]); z = interp2([1 2; 3 4], 1.5, 1.5);",
     EXACT),
    ("breadth4", "breadth4",
     "m = maxk([3 1 4 1 5 9 2 6], 3); n = mink([3 NaN 4 1 5], 2);"
     " [lo, hi] = bounds([3 -1 7]); r = rescale([1 2 3]); e = repelem([1 2], 2);"
     " f = fillmissing([1 NaN 3], 'previous'); s = nansum([1 NaN 2]);"
     " w = wrapToPi(4); h = heaviside([-1 0 1]); b = de2bi(5);"
     " mm = movmedian(1:6, 3); a = allfinite([1 Inf]);",
     EXACT),
    ("datetime-timing", "datetime_timing",
     "e = etime([2020 1 1 0 0 0], [2020 1 1 0 1 30.5]); c = numel(clock);"
     " t = cputime >= 0;",
     EXACT),
    ("ode-optim", "ode_optim",
     "[t, y] = ode45(@(t, y) -y, [0 1], 1); yend = y(end);"
     " x = fzero(@(x) x^2 - 2, [0 2]); m = fminsearch(@(x) (x - 3)^2, 0);"
     " q = integral(@(x) x.^2, 0, 1); c = cumtrapz([1 2 3]);",
     EXACT),
    ("optim2", "optim2",
     "x = fminunc(@(x) (x - 2)^2 + 1, 0); s = fsolve(@(x) x^3 - 8, 1);"
     " p = linprog([-1; -1], [1 1], 2, [], [], [0; 0], [2; 2]);",
     EXACT),
    ("breadth2", "breadth2",
     "g = gcd(12, 18); l = lcm(4, 6); p = primes(20); ip = isprime(7);"
     " n = nchoosek(5, 2); i = idivide(int32(7), int32(2)); b = dec2bin(10);"
     " h = hex2dec('FF'); s = sqrtm([4 0; 0 9]); k = skewness([1 2 3 10]);"
     " r = reverse('abc'); q = extractAfter('hello world', 'hello ');"
     " gr = gradient([1 4 9 16]);",
     EXACT),
    ("breadth3", "breadth3",
     "M = magic(4); T = toeplitz([1 2 3]); H = hilb(3); rng(4);"
     " a = normrnd(0, 1, 1, 3); u = unifrnd(0, 2, 1, 2); e = exprnd(1, 1, 2);"
     " r = range([4 9 1]); p = pow2(3); f = flintmax; after = rand;",
     EXACT),
    ("stats2", "stats2",
     "rng(6); x = normcdf(0.5); y = norminv(0.9); z = zscore([1 2 3 4]);"
     " g = geomean([1 4 16]); rm = rms([3 4]); t = unidrnd(6, 1, 4);"
     " s = randsample(10, 3); tr = tiedrank([3 1 3]); after = rand;",
     EXACT),
    ("stats3", "stats3",
     "a = betapdf(0.3, 2, 3); c = chi2inv(0.95, 2); e = expcdf(1, 2);"
     " g = gamcdf(2, 2, 1); p = poissinv(0.5, 3); u = unifcdf(0.3, 0, 1);"
     " x = xcov([1 2 3], [1 2 3]);",
     EXACT),
    ("strings2", "strings2",
     "s = strip('  hi  '); n = strlength('abcd'); c = compose('%d-%d', 1, 2);"
     " r = replace('abcabc', 'b', 'X'); t = strtok('one two');"
     " m = mat2str([1 2; 3 4]); i = int2str(3.7); a = append('ab', 'cd');",
     EXACT),
    ("signal2", "signal2",
     "[b, a] = butter(2, 0.3); d = downsample(1:10, 3); u = upsample([1 2], 2);"
     " f = filtfilt([1 1]/2, 1, [1 2 3 4 5 6 7 8]); w = fir1(4, 0.5);"
     " s = square(0.5);",
     EXACT),
    ("validators", "validators",
     "mustBePositive(3); mustBeInteger(4);"
     " v = validatestring('app', {'apple', 'banana'});"
     " try, mustBeNonnegative(-1); catch err, id = err.identifier; end",
     EXACT),
    ("timing2", "timing2",
     "t = timer('Period', 2); n = numel(timerfind) > 0; p = t.Period;"
     " clear t;",
     EXACT),
    ("profiler", "profiler",
     "profile on; x = sum(1:10); profile off; s = profile('status');",
     EXACT),
    ("symbolic", "symbolic",
     "syms x; e = expand((x + 1)^2); d = double(subs(x^2, x, 3));",
     EXACT),
    ("async", "async_builtins",
     "f = parfeval(@(a) a * 2, 1, 21); r = fetchOutputs(f); d = isdone(f);"
     " h = spawn(@() 5); v = await(h); w = wait(f); clear f h;",
     EXACT),
    ("sparse", "sparse_builtins",
     "A = sparse([1 2 3 3], [1 2 3 1], [4 5 6 1]); F = full(A);"
     " z = issparse(A); I = speye(3); O = spones(A); Z = spalloc(3, 3, 4);"
     " D = spdiags([1 2 3; 4 5 6; 7 8 9], [-1 0 1], 3, 3); nz = nonzeros(A);"
     " B = A' * I + A; y = B * [1; 2; 3]; x = A \\ [1; 2; 3];"
     " rng(2); R = sprand(4, 5, 0.3); S = sprandsym(5, 0.3); after = rand;",
     EXACT),
    ("itersolve", "itersolve",
     "n = 40; e = ones(n, 1); A = spdiags([-e 4*e -e], -1:1, n, n);"
     " xt = (1:n)' / n; b = A * xt; [x, flag, relres, it] = pcg(A, b, 1e-10, 200);"
     " L = ichol(A); [x2, f2] = pcg(A, b, 1e-10, 200, L, L');"
     " [y, fy] = bicgstab(A, b, 1e-10, 200); [g, fg] = gmres(A, b, 10, 1e-10, 20);"
     " [Li, Ui] = ilu(A);",
     EXACT),
    ("fea", "fea_builtins",
     "m = femesh([2 1 1], [4 2 2]); i = femesh_info(m); c = fea_node_coords(m);"
     " t = fea_boundary_nodes(m, 'x==L'); k = numel(t);"
     " r = fea_linear_static(m, 1000, 0.3, 'x==0', [t, zeros(k, 2), (-0.01/k)*ones(k, 1)]);"
     " u = r.max_displacement; th = fea_thermal(m, 3.7, {'x==0', 100; 'x==L', 0});"
     " T = th.temperature; clear m;",
     EXACT),
    ("ml", "ml",
     "rng(4); X = [randn(20, 2); randn(20, 2) + 5]; [idx, C] = kmeans(X, 2);"
     " [k, d] = knnsearch([0 0; 10 10; 5 5], [1 1; 9 8]);"
     " t = fitctree([1 2; 2 1; 8 9; 9 8], [1; 1; 2; 2]); p = predict(t, [1.5 1.5; 8.5 8.5]);"
     " b = regress([1; 3; 5; 7.5], [ones(4, 1), (1:4)']);"
     " [M, order] = confusionmat([1 1 2 2 3], [1 2 2 2 3]);"
     " c = cvpartition(10, 'KFold', 5); nt = sum(test(c, 1));"
     " D = pdist([0 0; 3 4; 6 8]); Z = squareform(D); clear t c;",
     EXACT),
    ("dl-builtins", "dl_builtins",
     "[p, v] = sgdmupdate([1 2], [0.5 0.5], [], 0.1, 0.9);"
     " [w, m, s] = adamupdate([1; 2], [0.1; -0.2], [], [], 1, 0.01);"
     " q = dlupdate(@(x) x * 2, [3 4]); r = relu([-1 0 2]); g = sigmoid([0 1]);"
     " sm = softmax([1; 2; 3]); ce = crossentropy(sm, [0; 0; 1]);"
     " e = mse([1 2], [2 4]) + l1loss([1 2], [2 4]) + huber([0 3], [0 0], 1);"
     " y = fullyconnect([1; 2], [1 2; 3 4], [0.5; -0.5]);"
     " l1 = struct('type', 'fc', 'W', [1 2; 3 4; 5 6], 'b', [0; 1; 2]);"
     " model = struct('Layers', {{l1, struct('type', 'relu'), struct('type', 'softmax')}});"
     " z = predict(model, [1 -1; 0.5 2]); a = isdlarray(z);",
     EXACT),
    ("dl-layers", "dl_layers",
     "layers = {featureInputLayer(3), fullyConnectedLayer(5), reluLayer,"
     " fullyConnectedLayer(2), softmaxLayer, classificationLayer};"
     " g = layerGraph(layers); net = dlnetwork(g); info = analyzeNetwork(net);"
     " rng(1); X = randn(12, 3); Y = [ones(6, 1); 2 * ones(6, 1)];"
     " y0 = predict(net, X'); f0 = forward(net, X');"
     " opts = trainingOptions('adam', 'MaxEpochs', 3, 'MiniBatchSize', 4);"
     " net2 = trainNetwork(X, Y, layers, opts); y2 = net2.predict(X');"
     " L = net2.Learnables; W1 = L{1};"
     " c = {imageInputLayer([6 6 1]), convolution2dLayer(3, 2, 'Padding', 'same'),"
     " batchNormalizationLayer, maxPooling2dLayer(2), averagePooling2dLayer(1),"
     " globalAveragePooling2dLayer, flattenLayer, dropoutLayer(0.3),"
     " layerNormalizationLayer, eluLayer, tanhLayer, sigmoidLayer, regressionLayer,"
     " sequenceInputLayer(2), lstmLayer(3, 'OutputMode', 'last'),"
     " bilstmLayer(2), convolution1dLayer(2, 3), globalAveragePooling1dLayer};"
     " n = numel(c); [P, Mk] = padsequences({[1 2 3], [4 5]}, 2);"
     " o = trainingOptions('sgdm'); lr = o.InitialLearnRate;"
     " net3 = trainnet(X, Y, layers, 'mse'); y3 = predict(net3, X');"
     " clear net net2 net3;",
     DL_FLOAT32),
]

# module -> the package its snippet needs beyond the port's own
NEEDS = {"symbolic": "sympy"}
