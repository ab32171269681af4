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

# the datetime, classdef, file and table modules: values of their own
# types stay in the workspace where they display as MATLAB does; a value
# that displays as its Python class (a categorical, a dictionary, a
# tokenized document, an inputParser) is cleared; files go under tempname
# and are deleted
SNIPPETS += [
    ("datetime", "datetime_builtins",
     "d = datetime(2026, 3, 14, 15, 9, 26); s = datestr(d); y = isdatetime(d);"
     " du = duration(2, 30, 0); h = isduration(du); d2 = d + du;"
     " w = weekday(d); n = datenum(2026, 1, 1); g = d2 > d;",
     EXACT),
    ("datetime2", "datetime2",
     "d = datetime(2024, 1, 31); e = dateshift(d, 'end', 'month');"
     " x = d + calmonths(1); y = d + calyears(1) + caldays(3);"
     " [yy, mm, dd] = ymd(d); [hh, mi, ss] = hms(d + hours(1.5));"
     " k = week(d); j = juliandate(d); p = posixtime(d); xl = exceltime(d);"
     " b = isbetween(d, datetime(2024, 1, 1), datetime(2024, 2, 1));",
     EXACT),
    ("datetime3", "datetime3",
     "v = datevec(datenum(2024, 7, 4, 6, 30, 0)); e = eomday(2024, 2);"
     " c = calendarDuration(0, 2, 3); q = iscalendarduration(c);"
     " b = isbusday(datenum(2024, 7, 4)); n = busdays(datenum(2024, 12, 23),"
     " datenum(2024, 12, 27)); d = daysdif(datenum(2024, 1, 1),"
     " datenum(2024, 3, 1)); h = holidays(datenum(2024, 6, 1),"
     " datenum(2024, 7, 31)); f = fbusdate(2024, 9); z = isnat(NaT);",
     EXACT),
    ("oop", "oop_builtins",
     "s.a = 1; o = isobject(s); v = isvalid(5); h = ishandle_object(5);",
     EXACT),
    ("file-io", "file_io",
     "p = [tempname '.txt']; fid = fopen(p, 'w'); fprintf(fid, 'a,%d\\n', 1:3);"
     " fclose(fid); t = fileread(p); fid = fopen(p, 'r'); l = fgetl(fid);"
     " fclose(fid); q = [tempname '.csv']; csvwrite(q, [1 2; 3 4]);"
     " M = csvread(q); m = [tempname '.mat']; x = magic(4); save(m, 'x');"
     " S = load(m); j = jsonencode(struct('k', [1 2])); J = jsondecode(j);"
     " f = fullfile('a', 'b.m'); delete(p); delete(q); delete(m);"
     " clear fid p q m",
     EXACT),
    ("io2", "io2",
     "[d, n, e] = fileparts('/x/y/z.txt'); p = [tempname '.txt'];"
     " writelines([\"one\" \"two\"], p); L = readlines(p); f = isfile(p);"
     " g = isfolder(p); q = [tempname '.txt']; dlmwrite(q, [1 2; 3 4]);"
     " D = dlmread(q); u = urlencode('a b&c'); w = urldecode(u);"
     " delete(p); delete(q); clear p q",
     EXACT),
    ("data-api", "data_api",
     "r = tempname; schema.arrays.x.shape = [2 2];"
     " ds = data_create(r, schema); tx = ds.begin(); tx.write('x', [1 2; 3 4]);"
     " tx.commit(); ds.refresh(); M = ds.array('x').read(); v = ds.version;"
     " e = data_exists(r); data_delete(r); g = data_exists(r);"
     " clear ds tx r ans",
     EXACT),
    ("introspection2", "introspection2",
     "p = inputParser; p.addRequired('x'); p.addParameter('scale', 2);"
     " p.parse(5, 'scale', 7); r = p.Results; k = iskeyword('for');"
     " n = namelengthmax; t = underlyingType(single(1)); m = ismethod(5, 'x');"
     " f = memoize(@sin); a = f(1); b = f(1); clear p f",
     EXACT),
    ("tables", "table_builtins",
     "T = array2table([3 1; 1 2; 2 3], 'VariableNames', {'a', 'b'});"
     " S = sortrows(T, 'a', 'descend'); h = height(S); w = width(S);"
     " U = addvars(T, [7; 8; 9], 'NewVariableNames', {'c'});"
     " A = table2array(U); R = renamevars(T, 'a', 'z'); H = head(T, 2);"
     " V = removevars(U, 'b'); s = table2struct(T); q = istable(T);",
     EXACT),
    ("table2", "table2",
     "c = categorical({'r', 'b', 'r'}); m = c == 'r'; k = categories(c);"
     " n = countcats(c); tt = timetable(datetime(2024, 1, 1) + hours([1 2 25])',"
     " [2; 4; 10]); w = retime(tt, 'daily', 'mean'); v = w.Var1;"
     " d = dictionary([\"a\" \"b\"], [1 2]); x = d(\"b\");"
     " T = cell2table({1, 'a'; 2, 'b'}, 'VariableNames', {'n', 's'});"
     " C = table2cell(T); g = groupsummary(table([1; 1; 2], [3; 4; 5],"
     " 'VariableNames', {'k', 'v'}), 'k', 'mean'); clear c d",
     EXACT),
    ("textanalytics", "textanalytics",
     "docs = tokenizedDocument([\"the quick fox\" \"the lazy dog\"]);"
     " bag = bagOfWords(docs); n = bag.NumWords; v = bag.Vocabulary;"
     " r = removeStopWords(docs); j = joinWords(r); s = stopWords;"
     " ns = numel(s); enc = wordEncoding(docs); i = word2ind(enc, \"fox\");"
     " clear docs bag r enc",
     EXACT),
]

# the plotting, control, image and graph modules: figures are closed and
# graphics handles, models and graphs cleared (they display as their
# Python class); files go under tempname and are deleted
SNIPPETS += [
    ("plotting", "plotting",
     "close all; f = figure; x = linspace(0, 1, 20); plot(x, x.^2, 'r--'); hold on;"
     " scatter(x, x); bar([1 2 3]); hold off; title('t'); xlabel('x');"
     " ylabel('y'); legend('a'); grid on; imagesc(magic(4)); colorbar;"
     " colormap('jet'); p = [tempname '.png']; print('-dpng', p);"
     " e = exist(p, 'file'); delete(p); close(f); clear p",
     EXACT),
    ("plotting2", "plotting2",
     "close all; f = figure; h = plot(1:3); set(h, 'LineWidth', 2);"
     " w = get(h, 'LineWidth'); xlim([0 4]); xl = xlim; g = isgraphics(h);"
     " close(f); clear h",
     EXACT),
    ("plotting3", "plotting3",
     "Z = peaks(8); [X, Y, S] = sphere(6); [x, y, z] = meshgrid(1:3);"
     " fv = isosurface(x, y, z, x + y + z, 6); nf = size(fv.faces, 1);"
     " V = smooth3(x .* y); close all",
     EXACT),
    ("control2", "control2",
     "sys = tf(1, [1 2 1]); p = pole(sys); k = dcgain(sys);"
     " y = step(sys, 0:0.5:3); s = isstable(sys); clear sys",
     EXACT),
    ("misc2", "misc2",
     "F = griddedInterpolant([1 2 3], [2 4 8]); v = F(2.5);"
     " c = namedargs2cell(struct('a', 1)); e = empty(0, 3);"
     " T = delaunay([0 1 0 1], [0 0 1 1]); q = interp1q([1; 2], [3; 5], 1.5);"
     " clear F",
     EXACT),
    ("domains", "domains",
     "k = fspecial('gaussian', 5, 1); X = reshape(1:36, 6, 6);"
     " Y = imfilter(X, k, 'replicate'); Z = imfilter(X, ones(2) / 4);"
     " G = graph([1 2 3], [2 3 4]); n = numnodes(G); P = shortestpath(G, 1, 4);"
     " c = blsprice(100, 95, 0.05, 1, 0.2); m = qammod([0 1 2 3], 4);"
     " clear G",
     EXACT),
    ("graph2", "graph2",
     "G = graph([1 1 2], [2 3 3]); v = bfsearch(G, 1); b = conncomp(G);"
     " D = distances(G); [g, id] = findgroups([3 1 3 2]');"
     " h = rgb2hsv([1 0 0]); clear G",
     EXACT),
]

# fea2: the study API without fea.run (which writes the run registry under
# HOME), finance and the subsref/subsasgn function forms
SNIPPETS += [
    ("fea2", "fea2",
     "g.box = [1 0.5 0.5]; g.resolution = 2;"
     " m = fea.model(g, fea.material('k', 45),"
     " fea.boundaryCondition('temperature', 'x=min', 300));"
     " st = fea.study(m, 'thermal'); p = fea.plan(st); ne = p.numElements;"
     " v = fea.validate(st); ok = v.valid;"
     " iv = blsimpv(100, 100, 0.05, 1, 10); [l, sg] = macd(1:40);"
     " A = [1 2; 3 4]; x = subsref(A, substruct('()', {2, 1}));"
     " B = subsasgn(A, substruct('()', {1, 2}), 9); clear g m st p v",
     EXACT),
]

# module -> the package its snippet needs beyond the port's own
NEEDS = {"symbolic": "sympy"}
