"""LIBERO closed-loop evaluation: 4 suites x 10 tasks x 50 trials.

Counterpart of experiments/robot/libero/run_libero_eval.py (the reference's
experiments/robot/libero/run_libero_eval.py:54-286). Needs the `libero`
simulator package: run it on a simulator host, with the policy in process on
the card (or `--device cpu`) or behind a REST server (`--remote_host`).

    python -m bridgelang_tpu_torch.experiments.robot.libero.run_libero_eval \
        --pretrained_checkpoint /ckpts/openvla-7b-libero --task_suite_name libero_spatial

Every field of the JAX script's `LiberoEvalConfig` under its name and
default, plus `--device` (the in-process policy's; CUDA unless `--device
cpu`, no fallback).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from bridgelang_tpu_torch.conf import parse_cli
from bridgelang_tpu_torch.experiments.robot.robot_utils import (
    get_action,
    get_model,
    invert_gripper_action,
    normalize_gripper_action,
    save_video,
    set_seed_everywhere,
)

NUM_SETTLE_STEPS = 10  # let objects drop before acting (reference :186-193)
TASK_MAX_STEPS = {
    "libero_spatial": 220, "libero_object": 280, "libero_goal": 300,
    "libero_10": 520, "libero_90": 400,
}


@dataclass
class LiberoEvalConfig:
    model_family: str = "openvla"
    pretrained_checkpoint: str = ""
    tokenizer_path: Optional[str] = None
    remote_host: Optional[str] = None
    remote_port: int = 8000
    task_suite_name: str = "libero_spatial"
    num_trials_per_task: int = 50
    unnorm_key: Optional[str] = None
    center_crop: bool = True  # models trained with image augmentation need this
    speculative: bool = False  # draft = the previous action's ids (greedy-equivalent)
    action_chunk: int = 1  # > 1: open-loop chunks (parallel-objective fine-tunes)
    seed: int = 7
    resolution: int = 256
    video_out_dir: Optional[str] = None
    # Local txt log and optional Weights & Biases (reference
    # run_libero_eval.py:243-282; wandb imported only when asked for).
    local_log_dir: str = "./experiments/logs"
    run_id_note: Optional[str] = None
    use_wandb: bool = False
    wandb_project: str = "bridgelang-tpu-eval"
    wandb_entity: Optional[str] = None
    device: Optional[str] = None  # the in-process policy's: cuda (default) | cpu


def get_libero_image(obs, resolution: int):
    """The agent-view camera turned upright (LIBERO renders it upside down)."""
    img = obs["agentview_image"]
    return img[::-1, ::-1]


def main(cfg: LiberoEvalConfig) -> None:
    try:
        from libero.libero import benchmark
        from libero.libero.envs import OffScreenRenderEnv
    except ImportError as e:
        raise SystemExit(
            "LIBERO simulator not installed. Install `libero` on a simulator host, and run the policy "
            "there or query a serving endpoint with --remote_host."
        ) from e

    set_seed_everywhere(cfg.seed)
    if cfg.unnorm_key is None:
        cfg.unnorm_key = f"{cfg.task_suite_name}_no_noops"
    model = get_model(cfg)

    suite = benchmark.get_benchmark_dict()[cfg.task_suite_name]()
    max_steps = TASK_MAX_STEPS[cfg.task_suite_name]

    # Local and wandb logging (reference :243-282)
    run_id = f"EVAL-{cfg.task_suite_name}-{cfg.model_family}-{time.strftime('%Y_%m_%d-%H_%M_%S')}"
    if cfg.run_id_note:
        run_id += f"--{cfg.run_id_note}"
    os.makedirs(cfg.local_log_dir, exist_ok=True)
    local_log_filepath = os.path.join(cfg.local_log_dir, run_id + ".txt")
    print(f"Logging to local log file: {local_log_filepath}")
    wandb_run = None
    if cfg.use_wandb:
        try:
            import wandb

            wandb_run = wandb.init(project=cfg.wandb_project, entity=cfg.wandb_entity, name=run_id)
        except ImportError:
            print("wandb not installed; continuing with local logging only")

    with open(local_log_filepath, "w") as log_file:

        def log(msg: str) -> None:
            print(msg)
            log_file.write(msg + "\n")
            log_file.flush()

        total_successes, total_episodes = 0, 0
        for task_id in range(suite.n_tasks):
            task = suite.get_task(task_id)
            env = OffScreenRenderEnv(
                bddl_file_name=str(Path(suite.get_task_bddl_file_path(task_id))),
                camera_heights=cfg.resolution, camera_widths=cfg.resolution,
            )
            task_successes = 0
            init_states = suite.get_task_init_states(task_id)
            for episode in range(cfg.num_trials_per_task):
                env.reset()
                if hasattr(model, "reset_episode"):
                    model.reset_episode()  # drop pending chunk actions and the draft
                obs = env.set_init_state(init_states[episode % len(init_states)])
                frames = []
                for _ in range(NUM_SETTLE_STEPS):
                    obs, *_ = env.step([0.0] * 6 + [-1.0])
                done = False
                for _ in range(max_steps):
                    try:
                        img = get_libero_image(obs, cfg.resolution)
                        frames.append(img)
                        action = get_action(cfg, model, {"full_image": img}, task.language)
                        # [0, 1] gripper -> [-1, 1], then inverted for LIBERO (-1 = open)
                        action = invert_gripper_action(normalize_gripper_action(action, binarize=True))
                        obs, reward, done, info = env.step(action.tolist())
                        if done:
                            break
                    except Exception as e:  # per-step containment ends the episode (reference :235-238)
                        print(f"[episode error] {e}")
                        break
                task_successes += int(done)
                total_successes += int(done)
                total_episodes += 1
                log(f"Success: {bool(done)} | episodes so far: {total_episodes} | "
                    f"successes: {total_successes} ({100.0 * total_successes / total_episodes:.1f}%)")
                if cfg.video_out_dir and frames:
                    name = f"task{task_id}_ep{episode}_{'ok' if done else 'fail'}.mp4"
                    save_video(frames, Path(cfg.video_out_dir) / name, fps=30)
            env.close()
            task_rate = task_successes / max(cfg.num_trials_per_task, 1)
            log(f"[task {task_id}] {task.language!r}: {task_successes}/{cfg.num_trials_per_task} = {task_rate:.3f}")
            if wandb_run is not None:
                wandb_run.log({
                    f"success_rate/{task.language}": task_rate,
                    f"num_episodes/{task.language}": cfg.num_trials_per_task,
                })
        total_rate = total_successes / max(total_episodes, 1)
        log(f"TOTAL success rate: {total_successes}/{total_episodes} = {total_rate:.3f}")
    if wandb_run is not None:
        wandb_run.log({"success_rate/total": total_rate, "num_episodes/total": total_episodes})
        wandb_run.save(local_log_filepath)
        wandb_run.finish()


if __name__ == "__main__":
    main(parse_cli(LiberoEvalConfig))
