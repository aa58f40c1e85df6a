"""BridgeData V2 real-robot (WidowX) evaluation loop at 5 Hz.

Counterpart of experiments/robot/bridge/run_bridgev2_eval.py (the
reference's experiments/robot/bridge/run_bridgev2_eval.py:37-183, with
widowx_env.py and bridgev2_utils.py). Needs the `widowx_envs` robot stack on
the robot workstation; the policy runs there on the card (or `--device cpu`)
or behind a REST server (`--remote_host`).

    python -m bridgelang_tpu_torch.experiments.robot.bridge.run_bridgev2_eval \
        --pretrained_checkpoint /ckpts/openvla-7b --host_ip <widowx server>

Kept from the reference: 5 Hz non-blocking control, center_crop must stay
off for Bridge, per-step exception containment ends the episode (never the
run), a replay video per episode, optional npz rollout data, the
redo-episode prompt. Every field of the JAX script's `BridgeEvalConfig`
under its name and default, plus `--device`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from bridgelang_tpu_torch.conf import parse_cli
from bridgelang_tpu_torch.experiments.robot.robot_utils import get_action, get_model, set_seed_everywhere


@dataclass
class BridgeEvalConfig:
    model_family: str = "openvla"
    pretrained_checkpoint: str = ""
    tokenizer_path: Optional[str] = None
    remote_host: Optional[str] = None       # REST policy server
    remote_port: int = 8000
    center_crop: bool = False               # must stay False for Bridge (reference :84)
    speculative: bool = False  # draft = previous action tokens (greedy-equivalent, ~40% faster)
    action_chunk: int = 1  # >1: open-loop chunk execution (parallel-objective fine-tunes)

    # WidowX environment (reference run_bridgev2_eval.py:53-71)
    host_ip: str = "localhost"
    port: int = 5556
    init_ee_pos: List[float] = field(default_factory=lambda: [0.3, -0.09, 0.26])
    init_ee_quat: List[float] = field(default_factory=lambda: [0, -0.259, 0, -0.966])
    bounds: List[List[float]] = field(default_factory=lambda: [
        [0.1, -0.20, -0.01, -1.57, 0],
        [0.45, 0.25, 0.30, 1.57, 0],
    ])
    camera_topics: List[Dict[str, str]] = field(default_factory=lambda: [{"name": "/blue/image_raw"}])
    blocking: bool = False
    max_episodes: int = 50
    max_steps: int = 60
    control_frequency: float = 5.0
    resize_hw: int = 256

    unnorm_key: str = "bridge_orig"
    save_data: bool = False                 # save npz rollout data per episode
    rollout_dir: str = "./rollouts"
    seed: int = 7
    device: Optional[str] = None            # the in-process policy's: cuda (default) | cpu


def main(cfg: BridgeEvalConfig) -> None:
    if cfg.center_crop:
        raise AssertionError("`center_crop` must be disabled for Bridge evaluations")
    try:
        from bridgelang_tpu_torch.experiments.robot.bridge.bridgev2_utils import (
            get_next_task_label,
            get_widowx_env,
            refresh_obs,
            save_rollout_data,
            save_rollout_video,
        )

        env = None
        set_seed_everywhere(cfg.seed)
        model = get_model(cfg)
        env = get_widowx_env(cfg)
    except ImportError as e:
        raise SystemExit(
            "WidowX robot stack not installed; run on the robot workstation "
            "(policy can stay remote via --remote_host)."
        ) from e

    task_label = ""
    episode_idx = 0
    step_duration = 1.0 / cfg.control_frequency
    while episode_idx < cfg.max_episodes:
        task_label = get_next_task_label(task_label)
        if task_label.lower() in ("quit", "exit"):
            break

        obs, _ = env.reset()
        if hasattr(model, "reset_episode"):
            model.reset_episode()  # flush pending chunk actions / drafts
        replay_images = []
        rollout_images, rollout_states, rollout_actions = [], [], []

        input(f"Press Enter to start episode {episode_idx + 1}...")
        print("Starting episode... Ctrl-C terminates the episode early!")
        t = 0
        last_tstamp = time.time()
        while t < cfg.max_steps:
            try:
                if time.time() < last_tstamp + step_duration:
                    continue
                last_tstamp = time.time()

                obs = refresh_obs(obs, env)
                if "full_image" in obs:
                    replay_images.append(obs["full_image"])

                action = get_action(cfg, model, {"full_image": obs["image_primary"]}, task_label)
                if cfg.save_data:
                    rollout_images.append(obs["image_primary"])
                    rollout_states.append(obs["proprio"])
                    rollout_actions.append(action)

                obs, _, _, truncated, _ = env.step(action)
                t += 1
                if truncated:
                    print("Lost connection to the action server; ending episode.")
                    break
            except (KeyboardInterrupt, Exception) as e:  # noqa: BLE001
                # Per-step containment: an episode may die, the eval never does
                # (reference run_bridgev2_eval.py:160-166).
                if isinstance(e, KeyboardInterrupt):
                    print("\nCaught KeyboardInterrupt: terminating episode early.")
                else:
                    print(f"\nCaught exception: {e}")
                break

        save_rollout_video(replay_images, episode_idx, out_dir=cfg.rollout_dir)
        if cfg.save_data:
            save_rollout_data(replay_images, rollout_images, rollout_states, rollout_actions,
                              episode_idx, out_dir=cfg.rollout_dir)
        if input("Enter 'r' to redo the episode, or press Enter to continue: ").strip() != "r":
            episode_idx += 1


if __name__ == "__main__":
    main(parse_cli(BridgeEvalConfig))
