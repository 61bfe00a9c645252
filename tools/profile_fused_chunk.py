"""Where a fused ``-O`` chunk's time goes on the card, at full width.

Writes the smoke's sphere scene, trains ``main_nerf -O``'s trainer
(``--steps_per_dispatch 16``) for 64 steps on it, then times one 16-step
chunk in its parts, each synchronized: the draws (from the trainer's
generator), their staging into the chunk's buffers, the 16 graph replays
(host clock and CUDA events), the replays under torch.profiler (device busy
share and events a step), a whole ``_run_fused_chunk``, and 15 steps of the
same trainer run one at a time (``_train_step``) for comparison.

    python tools/profile_fused_chunk.py

Needs one CUDA card; writes its workspace to ``workspace_profile_fused/``.
"""

import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_fused_chunk: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from focnerf_tpu_torch.apps.main_nerf import trainer_options
    from focnerf_tpu_torch.config import parse_options
    from focnerf_tpu_torch.train.fused import stage_hyper
    from focnerf_tpu_torch.train.trainer import Trainer
    from focnerf_tpu_torch.utils.measure import busy_ms, device_events

    dev = torch.device("cuda")
    work = os.path.join(ROOT, "workspace_profile_fused")
    shutil.rmtree(work, ignore_errors=True)
    scene = os.path.join(work, "scene")
    K = 16
    opt = parse_options([scene, "-O", "--iters", "250", "--steps_per_dispatch", str(K)])
    cs.write_training_scene(scene, opt.scale)
    ds = cs.train_dataset(scene, dev)
    tr = Trainer("ngp", opt.nerf_config(), workspace=os.path.join(work, "ws"), device=dev, **trainer_options(opt))
    tr.train(ds, None, max_epochs=1, steps_per_epoch=4 * K)
    chunk = next(iter(tr._fused_cache.values()))
    tr._maybe_update_occupancy()

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    cfgs, (P, _) = tr._cfg_phase_list()
    t0 = clock()
    draws, hypers = [], []
    for k in range(K):
        draws.append((ds.batch_draws(tr.generator), tr._step_draws(cfgs[k % P], opt.num_rays)))
        hypers.append(tr.state.hyper(k))
    t1 = clock()
    for k, (bd, sd) in enumerate(draws):
        chunk.batch_draws.put(k, bd)
        chunk.step_draws.put(k, sd)
    chunk.hyper[:K].copy_(stage_hyper(hypers, dev))
    chunk.occ.copy_(tr._occ_bits_for_batch(None))
    t2 = clock()

    def replays():
        chunk.steps.start()
        for k in range(K):
            chunk.steps.run(k % P, None)  # every key is captured: replays only

    replays()
    t3 = clock()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    replays()
    e1.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replays()
        torch.cuda.synchronize()
    events = list(device_events(prof))
    t4 = clock()
    tr._run_fused_chunk(ds, K)
    t5 = clock()
    one = Trainer("ngp", parse_options([scene, "-O", "--iters", "250"]).nerf_config(), workspace=os.path.join(
        work, "ws1"), device=dev, **trainer_options(parse_options([scene, "-O", "--iters", "250"])))
    one.train(ds, None, max_epochs=1, steps_per_epoch=4 * K + 1)  # its grid update at step 4K inside
    t6 = clock()
    for _ in range(K - 1):
        one._train_step(ds)
    t7 = clock()
    print(f"[profile-fused] one -O chunk of {K} at full width, ms/step: draws {(t1 - t0) * 1e3 / K:.3f}, "
          f"staging {(t2 - t1) * 1e3 / K:.3f}, graph replays {(t3 - t2) * 1e3 / K:.3f} (CUDA events "
          f"{e0.elapsed_time(e1) / K:.3f}; device busy {busy_ms(prof) / K:.3f}, {len(events) / K:.0f} device "
          f"events a step); a whole _run_fused_chunk {(t5 - t4) * 1e3 / K:.3f}; per step (the trainer at K 1) "
          f"{(t7 - t6) * 1e3 / (K - 1):.3f}")
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[profile-fused] {torch.cuda.get_device_name(0)} ({smi}), torch {torch.__version__}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
