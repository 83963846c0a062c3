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
    image -> clip -> u8 and the (N, T) scores (f32, TF32 off): the
    full-reference metrics on the lanes with reference frames, the
    no-reference ones on every lane

Lanes whose sequence has ended, and the windows past a lane's end in a
ragged chunk, voxelize as empty windows (``count`` is cleared first) and
their outputs are never read.

Hist-eq configs equalize each lane's clipped frames and f32 references on
the host and score the chunk's equalized (N, T) pairs in one device call.
Under ``EVREAL_RESUME`` finished lanes are skipped and the rest run as a
smaller group; each lane makes its own videos at the end.
"""

import numpy as np
import torch

from evreal_tpu_torch.data import pack_windows, plan_capacity
from evreal_tpu_torch.data.packing import alloc_buffers, outlier_buffers
from evreal_tpu_torch.harness.histeq import histogram_equalization
from evreal_tpu_torch.harness.runner import (
    MethodRunner,
    MetricContainment,
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
from evreal_tpu_torch.harness.timers import DeviceTimer, TimingLog
from evreal_tpu_torch.metrics import registry


class BatchedRunner(MethodRunner):
    """``MethodRunner`` over ``n`` sequences in lockstep: buffers carry a
    leading lane axis, ``(N, T, E)`` events and ``(N, T)`` counts."""

    def __init__(self, model, *, n, **kwargs):
        super().__init__(model, **kwargs)
        self.lanes = n

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
    """Evaluate one method on N same-resolution sequences in lockstep.
    Returns ``[(num_evaluated, mean_scores)]`` aligned with
    ``sequences``."""
    specs = registry.resolve(metrics)
    done = [check_resume(eval_config, dataset_name, s, method_name, specs)
            for s in sequences]
    if any(d is not None for d in done):
        keep = [s for s, d in zip(sequences, done) if d is None]
        rest = iter(eval_method_on_sequence_group(
            dataset_name, eval_config, method_name, bundle, method_config,
            keep, metrics, timings) if keep else [])
        return [d if d is not None else next(rest) for d in done]
    hist_eq = eval_config.get("histeq", "none")
    seqs = [s["dataset"] for s in sequences]
    n = len(seqs)
    resolution = tuple(seqs[0].sensor_resolution)
    runner = bundle.batched_runner_for(resolution, method_config,
                                       seqs[0].num_bins, n)
    device = runner.device
    trackers = [make_tracker(eval_config, dataset_name, s, method_name,
                             specs) for s in sequences]
    ref_lanes = [j for j, seq in enumerate(seqs) if seq.has_images]
    use = usable_metrics(runner, specs if ref_lanes else no_ref_specs(specs))
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
    pool = alloc_buffers((n, chunk_t), capacity, dtypes)
    ref_dtype = _ref_dtype(seqs, procs, metas_all)
    save_images = any(t.save_images for t in trackers)
    # hist-eq: the clipped frames come to the host to be equalized
    equalize = hist_eq != "none" and (
        bool(use) or any(t.save_processed_images for t in trackers))
    state = runner.init_state()

    def load_refs(chunk_idxs, valid_t):
        """(R, valid_t, H, W) reference frames of the R lanes that have
        them; rows past a lane's end stay zero (never recorded)."""
        refs = np.zeros((len(ref_lanes), valid_t) + resolution, ref_dtype)
        for r_lane, j in enumerate(ref_lanes):
            for r, i in enumerate(chunk_idxs[j]):
                fi = metas_all[j][i]["frame_index"]
                refs[r_lane, r] = (seqs[j].frame_u8(fi)
                                   if ref_dtype == np.uint8
                                   else seqs[j].frame(fi))
        return refs

    def score(imgs, refs):
        """{name: (N, T) scores} of the lanes' frames ``imgs``: the
        no-reference metrics on every lane, the full-reference ones on the
        ``ref_lanes`` against ``refs`` (R, T, H, W), NaN on the others
        (never recorded there)."""
        live = contain.live(use)
        out = runner.metric_scores(no_ref_specs(live), imgs, None, contain)
        fr = [s for s in live if not s.no_ref]
        if fr and len(ref_lanes) == n:
            out.update(runner.metric_scores(fr, imgs, refs, contain))
        elif fr:
            lanes = torch.tensor(ref_lanes, device=imgs.device)
            for name, v in runner.metric_scores(fr, imgs[lanes], refs,
                                                contain).items():
                out[name] = torch.full(imgs.shape[:2], float("nan"),
                                       device=imgs.device).index_copy_(
                                           0, lanes, v)
        return out

    def dispatch(k):
        nonlocal state
        chunk_idxs = [proc[k * chunk_t:(k + 1) * chunk_t] for proc in procs]
        valid_t = max(len(idxs) for idxs in chunk_idxs)
        chunk_max = max((metas_all[j][i]["event_count"]
                         for j in range(n) for i in chunk_idxs[j]),
                        default=0)
        if chunk_max <= capacity:
            cap_c, bufs, zeroed = capacity, pool, False
            # ended and padding lanes must voxelize as empty windows, not
            # as whatever the pool held for an earlier chunk
            bufs["count"][:] = 0
        else:  # outlier chunk (rare by plan_capacity): one-off buffers
            cap_c, bufs = outlier_buffers((n, chunk_t), chunk_max, dtypes)
            zeroed = True
        for j, (seq, idxs) in enumerate(zip(seqs, chunk_idxs)):
            if idxs:
                pack_windows(seq, idxs, capacity=cap_c,
                             out={key: v[j, :len(idxs)]
                                  for key, v in bufs.items()},
                             metas=[metas_all[j][i] for i in idxs],
                             out_zeroed=zeroed)
        state, _, clipped = runner.run(state, runner.upload(bufs), valid_t)
        out = {}
        if save_images:
            out["images"] = quantize_u8(clipped)
        if equalize:
            out["clipped"] = clipped
        elif use:
            refs = (runner.upload({"r": load_refs(chunk_idxs, valid_t)})["r"]
                    if ref_lanes else None)
            out.update(score(clipped, refs))
        return ((chunk_idxs,) + to_host(out),
                sum(len(idxs) for idxs in chunk_idxs))

    def equalize_chunk(chunk_idxs, clipped, host):
        """Equalized frames (N, T, H, W) of the lanes' windows; with
        metrics, the scores of the equalized frames (against the equalized
        references on the lanes that have them) go into ``host``. Rows past
        a lane's end stay zero (never recorded)."""
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
            dev = runner.upload({"i": processed, "r": refs})
            host.update({k: v.cpu().numpy()
                         for k, v in score(dev["i"], dev["r"]).items()})
        return processed

    def drain(entry):
        chunk_idxs, host, event = entry
        host = from_host(host, event)
        images = host.pop("images", None)
        clipped = host.pop("clipped", None)
        processed = (equalize_chunk(chunk_idxs, clipped, host)
                     if clipped is not None else None)
        for j, idxs in enumerate(chunk_idxs):
            for r, i in enumerate(idxs):
                record_window(trackers[j], seqs[j], i, metas_all[j][i],
                              images[j, r] if images is not None else None,
                              {key: v[j, r] for key, v in host.items()},
                              processed[j, r] if processed is not None
                              else None)

    timings = timings if timings is not None else TimingLog()
    max_chunks = max((-(-len(p) // chunk_t) for p in procs), default=0)
    total = sum(len(p) for p in procs)
    with DeviceTimer(timings, method_name, total, device) as timer:
        run_chunks(max_chunks, dispatch, drain, timer)

    results, first_err = [], None
    for tracker in trackers:
        # finish every tracker even if one sequence's writer failed
        try:
            finish_tracker(tracker, eval_config, contain.dead)
        except Exception as e:  # noqa: BLE001 — re-raised after the loop
            first_err = first_err or e
        results.append((tracker.get_num_quan_evaluations(),
                        tracker.get_mean_scores()))
    if first_err is not None:
        raise first_err
    return results
