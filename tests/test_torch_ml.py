"""The machine-learning builtins (`runtime/builtins/ml.py`) and `predict`
of a network through both packages' sessions, snippet by snippet, as
`tests/test_torch_parity.py` runs them: the JAX package's host session
against the port's host session and its session on `TorchEngine("cpu")`,
printed output and errors as text, workspace arrays exactly (tolerance 0)
or, where a snippet says so, within that relative tolerance."""

import pytest

from torch_both import EXACT, host_parity, no_engine  # noqa: F401

SNIPPETS = [
    ("kmeans", "rng(1); X = [randn(20, 2); randn(20, 2) + 5];"
               " [idx, C, sumd, D] = kmeans(X, 2); k3 = kmeans(X, 3);", EXACT),
    ("knnsearch", "[k, d] = knnsearch([0 0; 10 10; 5 5], [1 1; 9 8]);"
                  " k2 = knnsearch([1; 4; 9], [5; 0], 'K', 2);", EXACT),
    ("fitctree", "X = [1 2; 2 1; 8 9; 9 8; 1 9; 9 1]; y = [1; 1; 2; 2; 3; 3];"
                 " t = fitctree(X, y); p = predict(t, [1.5 1.5; 8.5 8.5; 1 8]);"
                 " clear t;", EXACT),
    ("regress", "b = regress([1; 3; 5; 7.5], [ones(4, 1), (1:4)']);"
                " [b2, bint] = regress([2; 4.1; 5.9; 8.2; 9.9],"
                " [ones(5, 1), (1:5)']); r = ridge([1; 2; 3], (1:3)', 0.5);",
     1e-12),
    ("confusionmat", "[C, order] = confusionmat([1 1 2 2 3 3], [1 2 2 2 3 1]);"
                     " C2 = confusionmat([2; 2; 1], [1; 2; 1]);", EXACT),
    ("cvpartition", "rng(1); c = cvpartition(10, 'KFold', 5); t1 = test(c, 1);"
                    " r1 = training(c, 1); h = cvpartition(20, 'HoldOut', 0.25);"
                    " nt = sum(test(h)); clear c h;", EXACT),
    ("fitclinear", "X = [0 0; 1 0; 0 1; 5 5; 6 5; 5 6]; y = [1; 1; 1; 2; 2; 2];"
                   " m = fitclinear(X, y); p = predict(m, [0 0.5; 5 5.5]);"
                   " clear m;", EXACT),
    ("predict-network", "net = dlnetwork({featureInputLayer(3),"
                        " fullyConnectedLayer(4), tanhLayer, fullyConnectedLayer(2),"
                        " softmaxLayer}); p = predict(net, [1 2; 0 -1; 3 0.5]);"
                        " clear net;", 1e-6),
    ("predict-trained", "rng(2); X = randn(16, 2); Y = 1 + (X(:, 1) > 0);"
                        " layers = {featureInputLayer(2), fullyConnectedLayer(4),"
                        " reluLayer, fullyConnectedLayer(2), softmaxLayer,"
                        " classificationLayer}; net = trainNetwork(X, Y, layers,"
                        " trainingOptions('sgdm', 'MaxEpochs', 4,"
                        " 'MiniBatchSize', 8)); p = predict(net, X');"
                        " clear net;", 1e-5),
    ("predict-layers-struct", "l1 = struct('type', 'fc', 'W', [1 2; 3 4],"
                              " 'b', [0; 1]); model = struct('Layers',"
                              " {{l1, struct('type', 'tanh')}});"
                              " p = predict(model, [1; -1]);", EXACT),
    ("pdist-linkage", "D = pdist([0 0; 3 4; 6 8; 1 1]); Z = linkage([0; 1; 10]);"
                      " S = squareform(D); D2 = pdist2([0 0; 1 1], [1 0]);",
     EXACT),
]


@pytest.mark.parametrize("sid,src,tol", SNIPPETS, ids=[s[0] for s in SNIPPETS])
def test_ml_snippet_matches_the_jax_host_path(no_engine, sid, src, tol):
    host_parity(sid, src, tol)
