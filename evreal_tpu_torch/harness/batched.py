"""The port's eval loop: lockstep evaluation of N same-resolution
sequences (``evreal_tpu/harness/batched.py``). Every sequence runs here:
one sequence (a dataset with one at its resolution, ``EVREAL_BATCH_N=1``,
``EVREAL_BATCHED=0``, a color config) is a group of one lane, with no
mesh, and computes what the JAX package's single-sequence loop does.

The recurrence forces window t to follow window t - 1 within a sequence,
but sequences are independent, so N of them run in lockstep as the batch
dimension of each model step: the state carries an N axis, every
convolution sees N images, and the per-chunk costs (one voxelizer launch,
the host's dispatch) are shared N ways. Windowing, eval-window gating and
the output files stay per sequence, on the host.

Per chunk of ``chunk_t`` windows:

    (N, T, E) event buffers -> device -> ONE voxelize_windows launch over
    the (N * T, E) view -> input norm (f32) -> serving dtype -> pad -> per
    window t: one model step of batch N -> f32 -> crop -> post-norm per
    image -> clip -> u8 and the (N, T) scores (f32, TF32 off unless
    ``EVREAL_PRECISION`` says otherwise): the
    full-reference metrics on the lanes with reference frames, the
    no-reference ones on every lane

The group narrows to its running lanes at chunk boundaries: chunk k runs
only the m lanes that still have windows in it, packed into the pool's
first m rows, so the upload, the voxelizer launch, every model step, the
post-norm, the u8 frames and the scores are of batch m. Lanes end in
order of their window counts (``gate_windows`` keeps a prefix), so the
running set only shrinks; when it does, each lane-first tensor of the
recurrent state is cut to the lanes left (``narrow_lanes``), and
``TimingLog`` counts the lanes dropped (``lockstep.narrowed``). The
windows past a lane's end in a ragged chunk voxelize as empty windows
(``count`` is cleared first) and their outputs are never read. The
JAX package runs every lane to the end, as a new batch shape means a
new XLA compile there; in eager PyTorch a narrower batch costs nothing
to set up.

Hist-eq configs equalize each running lane's clipped frames and f32
references on the host and score the chunk's equalized (m, T) pairs in
one device call. A color config's lane runs ``models/colornet.py:
ColorRunner`` (f32, the merged BGR frames saved and not scored).
Under ``EVREAL_RESUME`` finished lanes are skipped and the rest run as a
smaller group; each lane makes its own videos at the end.

Under a device mesh (``eval_mesh_for``: on a CUDA run every visible card
when there are more than one; ``EVREAL_MESH=0`` turns it off) a group of
more than one lane is padded to ``n_pad``, a multiple of dp, and its
lanes split into dp contiguous blocks, one per card (``ShardedRunner``):
per chunk the host uploads each block to its card, where one voxelizer
launch, the model steps, the post-norm, the u8 frames and the (lanes, T)
scores run with that card's model replica. Only the real lanes' results
come back, in lane order; the padding lanes voxelize as empty windows
and are never fetched. A mesh group does not narrow: its blocks stay
padded and dp-divisible, and every lane, ended ones too, runs to the
longest lane's end.
"""

import os

import numpy as np
import torch

from evreal_tpu_torch.data import pack_windows, plan_capacity
from evreal_tpu_torch.data.packing import alloc_buffers, outlier_buffers
from evreal_tpu_torch.harness.histeq import histogram_equalization
from evreal_tpu_torch.harness.runner import (
    MethodRunner,
    MetricContainment,
    abandon_on_error,
    check_color_histeq,
    check_resume,
    count_attention,
    equalized_refs,
    event_dtypes,
    finish_tracker,
    from_host,
    gate_windows,
    make_tracker,
    no_ref_specs,
    quantize_u8,
    record_window,
    run_chunks,
    to_host,
    usable_metrics,
)
from evreal_tpu_torch.harness.timers import (
    FETCH,
    PACK,
    RECORD,
    SCORE,
    SETUP,
    STEP,
    UPLOAD,
    DeviceTimer,
    TimingLog,
)
from evreal_tpu_torch.metrics import registry
from evreal_tpu_torch.parallel.mesh import (
    dp_devices,
    lane_blocks,
    make_mesh,
    pad_lanes,
)
from evreal_tpu_torch.utils.spans import span

_EVAL_MESH = "unset"


def get_eval_mesh():
    """The ``("dp",)`` mesh lockstep and serve groups shard their lanes
    over: every visible card when there are more than one, else None;
    ``EVREAL_MESH=0`` turns it off. Made once per process
    (``evreal_tpu/harness/batched.py:34-50``)."""
    global _EVAL_MESH
    if isinstance(_EVAL_MESH, str):
        count = torch.cuda.device_count()
        _EVAL_MESH = (make_mesh(count, axes=("dp",))
                      if os.environ.get("EVREAL_MESH", "1") != "0"
                      and count > 1 else None)
    return _EVAL_MESH


def eval_mesh_for(device):
    """The eval mesh when its devices are of ``device``'s kind, else None:
    a CUDA run shards over the cards, a CPU run on a host with several
    cards stays on the CPU, and a mesh of CPU entries set by the caller
    shards a CPU run exactly as given."""
    mesh = get_eval_mesh()
    kind = torch.device(device).type
    if mesh is None or any(d.type != kind for d in mesh.devices.flat):
        return None
    return mesh


class BatchedRunner(MethodRunner):
    """``MethodRunner`` over ``n`` sequences in lockstep: buffers carry a
    leading lane axis, ``(N, T, E)`` events and ``(N, T)`` counts."""

    def __init__(self, model, *, n, **kwargs):
        super().__init__(model, **kwargs)
        self.lanes = n

    def parts(self):
        """[(runner, lane block)]: the whole group on this device."""
        return [(self, slice(0, self.lanes))]

    @torch.no_grad()
    def run(self, state, bufs, valid_t):
        """One chunk of the M lanes that ``bufs`` holds (``count`` is (M,
        T); M is at most ``lanes``, and ``state`` holds the same M):
        voxelize all M * T windows in one launch, then run the first
        ``valid_t`` windows of every lane. Returns (state, images,
        clipped), each image tensor (M, valid_t, H, W)."""
        n, t = bufs["count"].shape
        vox = self.voxelize({k: v.reshape((n * t,) + tuple(v.shape[2:]))
                             for k, v in bufs.items()})
        vox = vox.view((n, t) + tuple(vox.shape[1:]))
        state, imgs = self.rollout(state, vox[:, :valid_t])
        return (state,) + self.post(imgs)


class ShardedRunner:
    """A lockstep group's lanes over a mesh's dp entries: one
    ``BatchedRunner`` per entry, over a contiguous block of the lanes, on
    the entry's device with that device's model replica. The one host
    thread uploads each shard's lanes, then enqueues each shard's work in
    turn (``upload_parts``, ``run_parts``)."""

    def __init__(self, runners):
        self.runners = list(runners)
        first = self.runners[0]
        self.lanes = sum(r.lanes for r in self.runners)
        self.blocks = lane_blocks(self.lanes, len(self.runners))
        self.chunk_t, self.h, self.w = first.chunk_t, first.h, first.w
        self.num_bins, self.dtype, self.device = (first.num_bins,
                                                  first.dtype, first.device)

    def parts(self):
        """[(runner, lane block)], one per shard, in lane order."""
        return list(zip(self.runners, self.blocks))

    def cost_analysis(self, states, buffers):
        """(FLOPs, None) of one chunk over every shard (``states`` from
        ``part_states``), the padding lanes included
        (``MethodRunner.cost_analysis``)."""
        return sum(r.cost_analysis(st, {k: v[b] for k, v in buffers.items()})
                   [0] for (r, b), st in zip(self.parts(), states)), None


def part_states(runner):
    """The recurrent state of each of ``runner.parts()``."""
    return [r.init_state() for r, _ in runner.parts()]


def upload_parts(runner, bufs):
    """One chunk of host buffers (lanes first) over ``runner.parts()``:
    each part's block of lanes uploaded to its device."""
    return [r.upload({k: v[block] for k, v in bufs.items()})
            for r, block in runner.parts()]


def run_parts(runner, states, parts_bufs, valid_t):
    """One chunk over ``runner.parts()``: each part's device buffers
    (``upload_parts``) run on its device (one voxelizer launch a part).
    Updates ``states`` in place; returns each part's clipped frames
    ``(lanes, valid_t, H, W)`` on its device."""
    out = []
    for p, ((r, _), bufs) in enumerate(zip(runner.parts(), parts_bufs)):
        states[p], _, clipped = r.run(states[p], bufs, valid_t)
        out.append(clipped)
    return out


def narrow_lanes(state, keep):
    """A recurrent state cut to the lanes ``keep`` (a device index
    tensor) of its lane axis: every tensor of one or more dimensions in
    the tree of dicts, lists and tuples (E2VID's ``(h, c)`` pairs,
    FireNet's dicts, ET-Net's lists) is lane-first; a 0-d tensor, such as
    SPADE-E2VID's ``initialized`` flag, belongs to every lane and stays."""
    if isinstance(state, dict):
        return {k: narrow_lanes(v, keep) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(narrow_lanes(v, keep) for v in state)
    if isinstance(state, torch.Tensor) and state.dim():
        return state.index_select(0, keep)
    return state


def _ref_dtype(seqs, procs, metas_all):
    """uint8 reference pools when every image-bearing sequence stores u8
    frames, else f32 (``evreal_tpu/harness/batched.py:394-404``)."""
    for seq, proc, metas in zip(seqs, procs, metas_all):
        if (seq.has_images and proc
                and seq.frame_u8(metas[proc[0]]["frame_index"]) is None):
            return np.float32
    return np.uint8


def eval_method_on_sequence_group(dataset_name, eval_config, method_name,
                                  bundle, method_config, sequences, metrics,
                                  timings=None):
    """Evaluate one method on N same-resolution sequences in lockstep,
    sharded over the eval mesh when there is one and N > 1 (a color
    config: one sequence). Returns ``[(num_evaluated, mean_scores)]``
    aligned with ``sequences``."""
    specs = registry.resolve(metrics)
    done = [check_resume(eval_config, dataset_name, s, method_name, specs)
            for s in sequences]
    if any(d is not None for d in done):
        keep = [s for s, d in zip(sequences, done) if d is None]
        rest = iter(eval_method_on_sequence_group(
            dataset_name, eval_config, method_name, bundle, method_config,
            keep, metrics, timings) if keep else [])
        return [d if d is not None else next(rest) for d in done]
    timings = timings if timings is not None else TimingLog()
    with span(SETUP):
        check_color_histeq(eval_config)
        color = eval_config.get("color", False)
        hist_eq = eval_config.get("histeq", "none")
        seqs = [s["dataset"] for s in sequences]
        n = len(seqs)
        resolution = tuple(seqs[0].sensor_resolution)
        # one sequence runs alone, as the JAX package's single loop does
        mesh = eval_mesh_for(bundle.device) if n > 1 else None
        # a dp-divisible lane count; the padding lanes are empty windows
        # whose outputs are never read
        # (evreal_tpu/harness/batched.py:353-357)
        n_pad = (pad_lanes(n, len(dp_devices(mesh))) if mesh is not None
                 else n)
        if color:
            runner = bundle.color_runner_for(resolution, method_config,
                                             seqs[0].num_bins)
        else:
            runner = bundle.batched_runner_for(resolution, method_config,
                                               seqs[0].num_bins, n_pad, mesh)
        parts = runner.parts()
        first = parts[0][0]
        trackers = [make_tracker(eval_config, dataset_name, s, method_name,
                                 specs) for s in sequences]
        # color frames are saved and not scored
        use = [] if color else usable_metrics(first, specs if any(
            seq.has_images for seq in seqs) else no_ref_specs(specs))
        contain = MetricContainment("group" if n > 1 else "sequence")
        eval_infer_all = eval_config.get("eval_infer_all", False)
        metas_all = [seq.windows() for seq in seqs]
        procs = [gate_windows(metas, s["start_time_s"], s["end_time_s"],
                              eval_infer_all)
                 for s, metas in zip(sequences, metas_all)]

        chunk_t = runner.chunk_t
        capacity = plan_capacity(metas_all[j][i]["event_count"]
                                 for j in range(n) for i in procs[j])
        dtypes = event_dtypes(seqs)
        pool = alloc_buffers((n_pad, chunk_t), capacity, dtypes)
        ref_dtype = _ref_dtype(seqs, procs, metas_all)
        save_images = any(t.save_images for t in trackers)
        # hist-eq: the clipped frames come to the host to be equalized
        equalize = hist_eq != "none" and (
            bool(use) or any(t.save_processed_images for t in trackers))
        states = part_states(runner)
        real_parts = sum(1 for _, block in parts if block.start < n)
        # the lanes the state holds, in row order: one part narrows to its
        # running lanes; a mesh keeps its padded, dp-divisible blocks
        narrow = len(parts) == 1
        running = list(range(n))

    def load_refs(chunk_idxs, valid_t, lanes):
        """(len(lanes), valid_t, H, W) reference frames of ``lanes`` (the
        group's lane numbers, each with frames); rows past a lane's end
        stay zero (never recorded)."""
        refs = np.zeros((len(lanes), valid_t) + resolution, ref_dtype)
        for r_lane, j in enumerate(lanes):
            for r, i in enumerate(chunk_idxs[j]):
                fi = metas_all[j][i]["frame_index"]
                refs[r_lane, r] = (seqs[j].frame_u8(fi)
                                   if ref_dtype == np.uint8
                                   else seqs[j].frame(fi))
        return refs

    def score(r, imgs, refs, with_refs):
        """{name: (L, T) scores} of the frames ``imgs`` of L rows (the
        chunk's running lanes, or a shard's block of them) on ``r``'s
        device: the no-reference metrics on every row, the full-reference
        ones on the rows ``with_refs`` (indices into ``imgs``) against
        ``refs`` (one row each), NaN on the others (never recorded
        there)."""
        live = contain.live(use)
        out = r.metric_scores(no_ref_specs(live), imgs, None, contain)
        fr = [s for s in live if not s.no_ref]
        if fr and len(with_refs) == len(imgs):
            out.update(r.metric_scores(fr, imgs, refs, contain))
        elif fr:
            nan = torch.full(imgs.shape[:2], float("nan"),
                             device=imgs.device)
            names = [s.name for s in fr]
            if with_refs:
                lanes = torch.tensor(with_refs, device=imgs.device)
                got = r.metric_scores(fr, imgs[lanes], refs, contain)
                out.update({k: nan.clone().index_copy_(0, lanes, v)
                            for k, v in got.items()})
                names = [k for k in names if k not in got]
            out.update({k: nan for k in names if k not in contain.dead})
        return out

    def dispatch(k):
        """Chunk k over its running lanes: row p of the pool, the state
        and every output is lane ``lanes[p]`` (a mesh: every lane, then
        the padding rows)."""
        nonlocal running
        chunk_idxs = [proc[k * chunk_t:(k + 1) * chunk_t] for proc in procs]
        live = [j for j in running if chunk_idxs[j]]
        if narrow and len(live) < len(running):
            keep = torch.tensor([running.index(j) for j in live],
                                device=first.device)
            states[0] = narrow_lanes(states[0], keep)
            timings.count("lockstep.narrowed", len(running) - len(live))
            running = live
        lanes, rows = running, (len(running) if narrow else n_pad)
        valid_t = max(len(chunk_idxs[j]) for j in lanes)
        chunk_max = max((metas_all[j][i]["event_count"]
                         for j in lanes for i in chunk_idxs[j]), default=0)
        with span(PACK):
            if chunk_max <= capacity:
                cap_c, zeroed = capacity, False
                bufs = {key: v[:rows] for key, v in pool.items()}
                # the windows past a lane's end (a mesh: ended and padding
                # lanes too) must voxelize as empty windows, not as
                # whatever the pool held for an earlier chunk
                bufs["count"][:] = 0
            else:  # outlier chunk (rare by plan_capacity): one-off buffers
                cap_c, bufs = outlier_buffers((rows, chunk_t), chunk_max,
                                              dtypes)
                zeroed = True
            for p, j in enumerate(lanes):
                idxs = chunk_idxs[j]
                if idxs:
                    pack_windows(seqs[j], idxs, capacity=cap_c,
                                 out={key: v[p, :len(idxs)]
                                      for key, v in bufs.items()},
                                 metas=[metas_all[j][i] for i in idxs],
                                 out_zeroed=zeroed)
        with span(UPLOAD):
            parts_bufs = upload_parts(runner, bufs)
        with span(STEP), count_attention(timings):
            clipped_parts = run_parts(runner, states, parts_bufs, valid_t)
        del parts_bufs  # back to the allocator before the scoring's buffers
        real_windows = sum(len(idxs) for idxs in chunk_idxs)
        # every row, a mesh's ended and padding lanes too, steps valid_t
        # windows
        timings.count("lane_windows.real", real_windows)
        timings.count("lane_windows.computed", rows * valid_t)
        out = {}
        for p, ((r, block), clipped) in enumerate(zip(parts, clipped_parts)):
            real = min(block.stop, len(lanes)) - block.start
            if real <= 0:  # padding lanes only: nothing is fetched
                continue
            clipped = clipped[:real]
            if save_images:
                out[p, "images"] = quantize_u8(clipped)
            if equalize:
                out[p, "clipped"] = clipped
            elif use:
                with span(SCORE):
                    mine = [q for q in range(block.start, block.start + real)
                            if seqs[lanes[q]].has_images]
                    refs = (r.upload({"r": load_refs(
                        chunk_idxs, valid_t, [lanes[q] for q in mine])})["r"]
                            if mine else None)
                    got = score(r, clipped, refs,
                                [q - block.start for q in mine])
                out.update({(p, name): v for name, v in got.items()})
        return (chunk_idxs, lanes) + to_host(out), real_windows

    def equalize_chunk(chunk_idxs, lanes, clipped, host):
        """Equalized frames (L, T, H, W) of the chunk's windows, row p
        lane ``lanes[p]``; with metrics, the scores of the equalized
        frames (against the equalized references on the rows whose lanes
        have them, on the first shard's device) go into ``host``. Rows
        past a lane's end stay zero (never recorded)."""
        processed = np.zeros_like(clipped)
        for p, j in enumerate(lanes):
            for r in range(len(chunk_idxs[j])):
                processed[p, r] = histogram_equalization(clipped[p, r],
                                                         hist_eq)
        if use:
            with_refs = [p for p, j in enumerate(lanes)
                         if seqs[j].has_images]
            refs = np.zeros((len(with_refs),) + clipped.shape[1:],
                            clipped.dtype)
            for r_row, p in enumerate(with_refs):
                j = lanes[p]
                if chunk_idxs[j]:
                    refs[r_row, :len(chunk_idxs[j])] = equalized_refs(
                        seqs[j], [metas_all[j][i] for i in chunk_idxs[j]],
                        hist_eq)
            dev = first.upload({"i": processed, "r": refs})
            host.update({k: v.cpu().numpy() for k, v in score(
                first, dev["i"], dev["r"], with_refs).items()})
        return processed

    def drain(entry):
        chunk_idxs, lanes, parts_host, events = entry
        host = {}
        with span(FETCH):
            fetched = from_host(parts_host, events)
        # the parts' real rows, in row order, per output name; a metric
        # that one part dropped at runtime is dropped from the whole chunk
        for (_, name), v in fetched.items():
            host.setdefault(name, []).append(v)
        host = {name: np.concatenate(vs) for name, vs in host.items()
                if len(vs) == real_parts}
        images = host.pop("images", None)
        clipped = host.pop("clipped", None)
        processed = None
        if clipped is not None:
            with span(SCORE):
                processed = equalize_chunk(chunk_idxs, lanes, clipped, host)
        with span(RECORD):
            for p, j in enumerate(lanes):
                for r, i in enumerate(chunk_idxs[j]):
                    record_window(trackers[j], seqs[j], i, metas_all[j][i],
                                  images[p, r] if images is not None
                                  else None,
                                  {key: v[p, r] for key, v in host.items()},
                                  processed[p, r] if processed is not None
                                  else None)

    max_chunks = max((-(-len(p) // chunk_t) for p in procs), default=0)
    total = sum(len(p) for p in procs)
    with abandon_on_error(trackers), DeviceTimer(
            timings, method_name, total,
            [r.device for r, _ in parts]) as timer:
        run_chunks(max_chunks, dispatch, drain, timer)

    results, first_err = [], None
    for tracker in trackers:
        # finish every tracker even if one sequence's writer failed, so
        # that the others write their queued frames and stop their threads
        try:
            finish_tracker(tracker, eval_config, contain.dead, timings)
        except Exception as e:  # noqa: BLE001 — re-raised after the loop
            first_err = first_err or e
        results.append((tracker.get_num_quan_evaluations(),
                        tracker.get_mean_scores()))
    if first_err is not None:
        raise first_err
    return results
