"""Regenerate LIBERO datasets: replay HDF5 demos, drop no-ops and failed
replays, re-render at 256 px, and write episodes to TFRecords through the
port's native writer.

Counterpart of experiments/robot/libero/regenerate_libero_dataset.py (the
reference's regenerate_libero_dataset.py: `is_noop` :46-68, the replay loop
:112-214). Needs `libero` and `h5py` (a simulator host); both are imported
inside `main`. The replay contract is the reference's:

  * 10 settle steps with the dummy action after set_init_state;
  * the observation at time t is recorded BEFORE action t executes;
  * no-op actions are skipped, not executed: near-zero movement with the
    gripper of the last KEPT action;
  * only successful replays are written; a metainfo JSON records each
    episode's success and initial state.

Each record is an npz-in-bytes episode (`_serialize_episode`), the JAX
script's format.

    python -m bridgelang_tpu_torch.experiments.robot.libero.regenerate_libero_dataset \
        --libero_task_suite libero_spatial --libero_raw_data_dir ./raw --out_dir ./regen
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from bridgelang_tpu_torch.conf import parse_cli

NOOP_ACTION = [0.0] * 6 + [-1.0]
NUM_SETTLE_STEPS = 10


def is_noop(action: np.ndarray, prev_action: np.ndarray = None, threshold: float = 1e-4) -> bool:
    """No movement AND the gripper of the last KEPT action (reference
    :46-68): still frames teach the policy to freeze, but a still robot
    operating its gripper is not a no-op."""
    no_movement = np.linalg.norm(action[:-1]) < threshold
    if prev_action is None:
        return bool(no_movement)
    return bool(no_movement and action[-1] == prev_action[-1])


@dataclass
class RegenConfig:
    libero_task_suite: str = "libero_spatial"
    libero_raw_data_dir: str = "raw"
    out_dir: str = "regenerated"
    resolution: int = 256


def main(cfg: RegenConfig) -> None:
    try:
        import h5py
        from libero.libero import benchmark
        from libero.libero.envs import OffScreenRenderEnv
    except ImportError as e:
        raise SystemExit("Requires `libero` + `h5py` (a simulator host).") from e

    from bridgelang_tpu_torch import native

    suite = benchmark.get_benchmark_dict()[cfg.libero_task_suite]()
    out_root = Path(cfg.out_dir) / f"{cfg.libero_task_suite}_no_noops"
    out_root.mkdir(parents=True, exist_ok=True)

    metainfo: dict = {}
    n_kept, n_noops, n_replays, n_success = 0, 0, 0, 0
    for task_id in range(suite.n_tasks):
        task = suite.get_task(task_id)
        h5_path = Path(cfg.libero_raw_data_dir) / f"{task.name}_demo.hdf5"
        if not h5_path.exists():
            print(f"[skip] missing {h5_path}")
            continue
        env = OffScreenRenderEnv(
            bddl_file_name=str(suite.get_task_bddl_file_path(task_id)),
            camera_heights=cfg.resolution, camera_widths=cfg.resolution,
        )
        writer = native.TFRecordWriter(str(out_root / f"task{task_id:02d}.tfrecord"))
        try:
            with h5py.File(h5_path, "r") as f:
                for demo_key in f["data"]:
                    demo = f["data"][demo_key]
                    actions = np.asarray(demo["actions"])
                    states = np.asarray(demo["states"])

                    env.reset()
                    env.set_init_state(states[0])
                    obs = None
                    for _ in range(NUM_SETTLE_STEPS):  # let objects drop (reference :126-128)
                        obs, reward, done, info = env.step(NOOP_ACTION)

                    steps, done = [], False
                    for t in range(len(actions)):
                        # prev = the last KEPT action (reference :139): dropped
                        # frames must not reset the gripper-change detector.
                        prev = steps[-1]["action"] if steps else None
                        if is_noop(actions[t], prev):
                            n_noops += 1
                            continue  # no-ops are never executed (reference :140-143)
                        # Record the CURRENT observation with action t, THEN step.
                        steps.append({
                            "image": obs["agentview_image"][::-1, ::-1],
                            "wrist_image": obs["robot0_eye_in_hand_image"][::-1, ::-1],
                            "state": np.concatenate([
                                obs["robot0_eef_pos"], obs["robot0_eef_quat"], obs["robot0_gripper_qpos"],
                            ]),
                            "joint_state": np.asarray(obs["robot0_joint_pos"]),
                            "action": actions[t],
                        })
                        obs, reward, done, info = env.step(actions[t].tolist())

                    n_replays += 1
                    task_key = task.language.replace(" ", "_")
                    metainfo.setdefault(task_key, {})[str(demo_key)] = {
                        "success": bool(done),
                        "initial_state": np.asarray(states[0]).tolist(),
                    }
                    if not done:  # failed replays are left out (reference :179)
                        continue
                    writer.write(_serialize_episode(steps, task.language))
                    n_kept += len(steps)
                    n_success += 1
        finally:
            writer.close()
            env.close()

    (out_root / "meta.json").write_text(json.dumps({
        "suite": cfg.libero_task_suite, "frames": n_kept,
        "replays": n_replays, "successes": n_success, "noops_dropped": n_noops,
    }))
    (out_root / f"{cfg.libero_task_suite}_metainfo.json").write_text(json.dumps(metainfo, indent=2))
    print(f"kept {n_kept} frames over {n_success}/{n_replays} successful replays "
          f"({n_noops} no-op frames dropped)")


def _serialize_episode(steps, language: str) -> bytes:
    """One episode as compressed npz bytes (self-describing: the native
    reader, then np.load)."""
    buf = io.BytesIO()
    np.savez_compressed(
        buf,
        images=np.stack([s["image"] for s in steps]),
        wrist_images=np.stack([s["wrist_image"] for s in steps]),
        states=np.stack([s["state"] for s in steps]).astype(np.float32),
        joint_states=np.stack([s["joint_state"] for s in steps]).astype(np.float32),
        actions=np.stack([s["action"] for s in steps]).astype(np.float32),
        language=np.array(language),
    )
    return buf.getvalue()


if __name__ == "__main__":
    main(parse_cli(RegenConfig))
