% MathWorks' "Sequence Classification Using Deep Learning" (the Japanese
% Vowels example) on one card: its network, a sequence input of 12
% features, an LSTM of 100 hidden units whose last output feeds a fully
% connected layer of 9, softmax and classification, trained with Adam in
% minibatches of 27 over 270 training sequences ('GradientThreshold' 1,
% 'Shuffle' 'never', as the example sets them; the trainer reads neither).
% Cuts: the data and the depth. The UCI Japanese Vowels set is not in the
% repository, so 270 sequences of 12 features, 30 for each of 9 classes,
% are made with rng: noise around a mean vector of the class. Each is 26
% steps long (the example pads its 7-26 steps to the longest, 26), given
% as N x T x F. EPOCHS defaults to the example's 50; predict on the
% training set and print the accuracy. Set EPOCHS before running.
if ~exist('EPOCHS', 'var'), EPOCHS = 50; end
rng(0);
N = 270; T = 26; F = 12;
Y = repmat((1:9)', N / 9, 1);
M = randn(9, F);
X = 0.6 * randn(N, T, F) + reshape(M(Y, :), N, 1, F);
layers = {sequenceInputLayer(F), lstmLayer(100, 'OutputMode', 'last'), ...
    fullyConnectedLayer(9), softmaxLayer, classificationLayer};
opts = trainingOptions('adam', 'MaxEpochs', EPOCHS, 'MiniBatchSize', 27, ...
    'GradientThreshold', 1, 'Shuffle', 'never');
net = trainNetwork(X, Y, layers, opts);
P = predict(net, permute(X, [3 2 1]));
[~, cls] = max(P, [], 1);
acc = mean(cls' == Y);
fprintf('RESULT_ok VOWELS=%.6f\n', acc);
