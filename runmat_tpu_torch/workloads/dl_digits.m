% MathWorks' "Create Simple Deep Learning Neural Network for
% Classification" (the DigitDataset example) on one card: its network,
% three blocks of a 3x3 'same' convolution (8, 16 and 32 filters), batch
% normalization and relu, a 2x2 max pooling of stride 2 after the first
% two, a fully connected layer of 10, softmax and classification, trained
% with its options (sgdm, learning rate 0.01, 4 epochs, minibatches of
% 128). A flattenLayer stands before the fully connected layer, as the
% runtime's fc layer takes features x batch.
% Cuts: the data. The example's 7,500 training images of 28x28x1 (of the
% 10,000 in DigitDataset, which is not in the repository) are made here
% with rng at the same size and type: noise plus a bright band of three
% rows whose place is set by the label, so the label is a function of the
% image. The example's 'Shuffle','every-epoch' and its validation data are
% dropped (the trainer shuffles nothing and validates nothing). Then
% predict on the first NP images and print the accuracy on them.
% Set N, EPOCHS or NP before running.
if ~exist('N', 'var'), N = 7500; end
if ~exist('EPOCHS', 'var'), EPOCHS = 4; end
if ~exist('NP', 'var'), NP = 1000; end
rng(0);
Y = randi(10, N, 1);
rows = (1:28)';
band = single(abs(rows - (2.5 * Y' + 0.5)) < 1.5);
X = 0.5 * rand(28, 28, 1, N, 'single') + 0.5 * reshape(band, 28, 1, 1, N);
layers = {imageInputLayer([28 28 1]), ...
    convolution2dLayer(3, 8, 'Padding', 'same'), batchNormalizationLayer, reluLayer, ...
    maxPooling2dLayer(2, 'Stride', 2), ...
    convolution2dLayer(3, 16, 'Padding', 'same'), batchNormalizationLayer, reluLayer, ...
    maxPooling2dLayer(2, 'Stride', 2), ...
    convolution2dLayer(3, 32, 'Padding', 'same'), batchNormalizationLayer, reluLayer, ...
    flattenLayer, fullyConnectedLayer(10), softmaxLayer, classificationLayer};
opts = trainingOptions('sgdm', 'InitialLearnRate', 0.01, 'MaxEpochs', EPOCHS, ...
    'MiniBatchSize', 128);
net = trainNetwork(X, Y, layers, opts);
P = predict(net, X(:, :, :, 1:NP));
[~, cls] = max(P, [], 1);
acc = mean(cls' == Y(1:NP));
fprintf('RESULT_ok DIGITS=%.6f\n', acc);
