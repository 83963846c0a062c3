"""Lockstep batched evaluation of N same-resolution sequences
(``evreal_tpu/harness/batched.py``).

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

Lanes whose sequence has ended, and the windows past a lane's end in a
ragged chunk, voxelize as empty windows (``count`` is cleared first) and
their outputs are never read.

Hist-eq configs equalize each lane's clipped frames and f32 references on
the host and score the chunk's equalized (N, T) pairs in one device call.
Under ``EVREAL_RESUME`` finished lanes are skipped and the rest run as a
smaller group; each lane makes its own videos at the end.

Under a device mesh (``eval_mesh_for``: on a CUDA run every visible card
when there are more than one; ``EVREAL_MESH=0`` turns it off) the group is padded to
``n_pad``, a multiple of dp, and its lanes split into dp contiguous
blocks, one per card (``ShardedRunner``): per chunk the host uploads
each block to its card, where one voxelizer launch, the model steps, the
post-norm, the u8 frames and the (lanes, T) scores run with that card's
model replica. Only the real lanes' results come back, in lane order;
the padding lanes voxelize as empty windows and are never fetched.
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
    check_resume,
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
    span,
)
from evreal_tpu_torch.metrics import registry
from evreal_tpu_torch.parallel.mesh import (
    dp_devices,
    lane_blocks,
    make_mesh,
    pad_lanes,
)

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
        """One chunk: voxelize all N * T windows in one launch, then run
        the first ``valid_t`` windows of every lane. Returns (state,
        images, clipped), each image tensor (N, valid_t, H, W)."""
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
    sharded over the eval mesh when there is one. Returns
    ``[(num_evaluated, mean_scores)]`` aligned with ``sequences``."""
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
        hist_eq = eval_config.get("histeq", "none")
        seqs = [s["dataset"] for s in sequences]
        n = len(seqs)
        resolution = tuple(seqs[0].sensor_resolution)
        mesh = eval_mesh_for(bundle.device)
        # a dp-divisible lane count; the padding lanes are empty windows
        # whose outputs are never read
        # (evreal_tpu/harness/batched.py:353-357)
        n_pad = (pad_lanes(n, len(dp_devices(mesh))) if mesh is not None
                 else n)
        runner = bundle.batched_runner_for(resolution, method_config,
                                           seqs[0].num_bins, n_pad, mesh)
        parts = runner.parts()
        first = parts[0][0]
        trackers = [make_tracker(eval_config, dataset_name, s, method_name,
                                 specs) for s in sequences]
        ref_lanes = [j for j, seq in enumerate(seqs) if seq.has_images]
        use = usable_metrics(first,
                             specs if ref_lanes else no_ref_specs(specs))
        contain = MetricContainment("group")
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

    def load_refs(chunk_idxs, valid_t, lanes):
        """(len(lanes), valid_t, H, W) reference frames of ``lanes`` (each
        with frames); rows past a lane's end stay zero (never recorded)."""
        refs = np.zeros((len(lanes), valid_t) + resolution, ref_dtype)
        for r_lane, j in enumerate(lanes):
            for r, i in enumerate(chunk_idxs[j]):
                fi = metas_all[j][i]["frame_index"]
                refs[r_lane, r] = (seqs[j].frame_u8(fi)
                                   if ref_dtype == np.uint8
                                   else seqs[j].frame(fi))
        return refs

    def score(r, imgs, refs, with_refs):
        """{name: (L, T) scores} of the L lanes' frames ``imgs`` on ``r``'s
        device: the no-reference metrics on every lane, the full-reference
        ones on the lanes ``with_refs`` (indices into ``imgs``) against
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
        chunk_idxs = [proc[k * chunk_t:(k + 1) * chunk_t] for proc in procs]
        valid_t = max(len(idxs) for idxs in chunk_idxs)
        chunk_max = max((metas_all[j][i]["event_count"]
                         for j in range(n) for i in chunk_idxs[j]),
                        default=0)
        with span(PACK):
            if chunk_max <= capacity:
                cap_c, bufs, zeroed = capacity, pool, False
                # ended and padding lanes must voxelize as empty windows,
                # not as whatever the pool held for an earlier chunk
                bufs["count"][:] = 0
            else:  # outlier chunk (rare by plan_capacity): one-off buffers
                cap_c, bufs = outlier_buffers((n_pad, chunk_t), chunk_max,
                                              dtypes)
                zeroed = True
            for j, (seq, idxs) in enumerate(zip(seqs, chunk_idxs)):
                if idxs:
                    pack_windows(seq, idxs, capacity=cap_c,
                                 out={key: v[j, :len(idxs)]
                                      for key, v in bufs.items()},
                                 metas=[metas_all[j][i] for i in idxs],
                                 out_zeroed=zeroed)
        with span(UPLOAD):
            parts_bufs = upload_parts(runner, bufs)
        with span(STEP):
            clipped_parts = run_parts(runner, states, parts_bufs, valid_t)
        del parts_bufs  # back to the allocator before the scoring's buffers
        real_windows = sum(len(idxs) for idxs in chunk_idxs)
        # every lane, ended and padding ones too, steps valid_t windows
        timings.count("lane_windows.real", real_windows)
        timings.count("lane_windows.computed", n_pad * valid_t)
        out = {}
        for p, ((r, block), clipped) in enumerate(zip(parts, clipped_parts)):
            real = min(block.stop, n) - block.start
            if real <= 0:  # padding lanes only: nothing is fetched
                continue
            clipped = clipped[:real]
            if save_images:
                out[p, "images"] = quantize_u8(clipped)
            if equalize:
                out[p, "clipped"] = clipped
            elif use:
                with span(SCORE):
                    mine = [j for j in ref_lanes
                            if block.start <= j < block.stop]
                    refs = (r.upload({"r": load_refs(chunk_idxs, valid_t,
                                                     mine)})["r"]
                            if mine else None)
                    got = score(r, clipped, refs,
                                [j - block.start for j in mine])
                out.update({(p, name): v for name, v in got.items()})
        return (chunk_idxs,) + to_host(out), real_windows

    def equalize_chunk(chunk_idxs, clipped, host):
        """Equalized frames (N, T, H, W) of the lanes' windows; with
        metrics, the scores of the equalized frames (against the equalized
        references on the lanes that have them, on the first shard's
        device) go into ``host``. Rows past a lane's end stay zero (never
        recorded)."""
        processed = np.zeros_like(clipped)
        for j, idxs in enumerate(chunk_idxs):
            for r in range(len(idxs)):
                processed[j, r] = histogram_equalization(clipped[j, r],
                                                         hist_eq)
        if use:
            refs = np.zeros((len(ref_lanes),) + clipped.shape[1:],
                            clipped.dtype)
            for r_lane, j in enumerate(ref_lanes):
                idxs = chunk_idxs[j]
                if idxs:
                    refs[r_lane, :len(idxs)] = equalized_refs(
                        seqs[j], [metas_all[j][i] for i in idxs], hist_eq)
            dev = first.upload({"i": processed, "r": refs})
            host.update({k: v.cpu().numpy() for k, v in score(
                first, dev["i"], dev["r"], ref_lanes).items()})
        return processed

    def drain(entry):
        chunk_idxs, parts_host, events = entry
        host = {}
        with span(FETCH):
            fetched = from_host(parts_host, events)
        # the parts' real lanes, in lane order, per output name; a metric
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
                processed = equalize_chunk(chunk_idxs, clipped, host)
        with span(RECORD):
            for j, idxs in enumerate(chunk_idxs):
                for r, i in enumerate(idxs):
                    record_window(trackers[j], seqs[j], i, metas_all[j][i],
                                  images[j, r] if images is not None
                                  else None,
                                  {key: v[j, r] for key, v in host.items()},
                                  processed[j, r] if processed is not None
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
