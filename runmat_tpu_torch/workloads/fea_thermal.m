% A steady thermal study of one part, as an engineer writes it with the
% fea.* study API. Part 1: a 1 m steel cube (k = 45 W/(m K)) meshed at
% R elements an edge (R = 64: 274,625 nodes, 1,572,864 TET4 elements),
% held at 300 K on its x = min face and 400 K on its x = max face, with the
% study's source (fea.run's 100 W at every node); the conduction matrix is
% symmetric and has more than 2048 free unknowns, so its solve runs
% conjugate gradient on the device. The temperatures are binned on the
% device where there is one (histcounts of a gpuArray over 64 bins across
% their range), drawn, written to an evidence artifact and replayed by
% fea.verifyEvidence (whose replay re-runs the recorded spec: the box,
% material and physics, not the authored conditions). Part 2: a
% plate with a through bore read from a STEP file (stepfile), its B-rep
% faces listed and meshed at edge length hs, and a thermal study whose
% conditions select the bore's wall by its face id. Set R, hs and stepfile
% before running; files go under tempname and are deleted.
if ~exist('R', 'var'), R = 64; end
if ~exist('hs', 'var'), hs = 0.14; end
if ~exist('stepfile', 'var')
    stepfile = fullfile(matlabroot, 'workloads', 'plate_bore.step');
end
% part 1: the cube
geom.box = [1 1 1];
geom.resolution = R;
steel = fea.material('name', 'steel', 'k', 45);
cold = fea.boundaryCondition('temperature', 'x=min', 300);
hot = fea.boundaryCondition('temperature', 'x=max', 400);
model = fea.model(geom, steel, cold, hot);
study = fea.study(model, 'thermal');
val = fea.validate(study);
if ~val.valid, error('thermal:invalid', 'the study does not validate'); end
p = fea.plan(study);
r = fea.run(study);
T = fea.field(r, 'temperature');
edges = linspace(min(T), max(T), 65);
if gpuDeviceCount > 0
    Tg = gpuArray(T);                         % binned on the device
else
    Tg = T;                                   % no device: on the host
end
n = gather(histcounts(Tg, edges));
if sum(n) ~= numel(T)
    error('thermal:histogram', '%d of %d temperatures binned', sum(n), numel(T));
end
f1 = figure;
fea.plot(r, 'temperature');
base = tempname;
png = [base '.png'];
print('-dpng', png);
png_ok = exist(png, 'file') == 2;
delete(png);
ev = [base '.evidence.json'];
e = fea.evidence(r, ev);
v = fea.verifyEvidence(ev);
delete(ev);
close(f1);
fprintf('cube: %d nodes, %d elements, T in [%.6f, %.6f], %d bins\n', ...
    p.numNodes, p.numElements, min(T), max(T), numel(n));
fprintf('evidence %s, replay ok %d (%d problems)\n', e.hash(1:12), ...
    v.ok, numel(v.problems));
% part 2: the plate with a bore, from STEP
g = geometry.load(stepfile);
regions = geometry.listRegions(g);
info = g.faceInfo;
bore = 0;
for k = 1:numel(info)
    if strcmp(info(k).type, 'CYLINDRICAL_SURFACE'), bore = info(k).id; end
end
t0 = tic;
m = geometry.meshes(g, hs);                   % the host mesher, timed
tmesh = toc(t0);
g.resolution = hs;
heated = fea.boundaryCondition('temperature', sprintf('face:%d', bore), 350);
side = fea.boundaryCondition('temperature', 'x=min', 300);
rp = fea.run(fea.study(fea.model(g, steel, heated, side), 'thermal'));
Tp = fea.field(rp, 'temperature');
fprintf(['plate: %d faces (bore face %d), meshed at %g in %.1f s, ' ...
    '%d nodes, T in [%.6f, %.6f]\n'], numel(info), bore, hs, tmesh, ...
    size(rp.mesh.nodes, 1), min(Tp), max(Tp));
fprintf('RESULT_ok PLATE=%.12e\n', sum(Tp));
fprintf('RESULT_ok THERMAL=%.12e\n', sum(T));
