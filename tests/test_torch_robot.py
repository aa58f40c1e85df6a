"""The port's robot-evaluation side against the JAX package's, on the CPU:
`preprocess_image` and `crop_and_resize_eval`, the harnesses' policy side
(`bridgelang_tpu_torch/experiments/robot/`), the LIBERO harness end to end
over a fake `libero` package in every policy mode, the WidowX wrapper, the
BridgeV2 loop over a fake robot stack, and the LIBERO regeneration replay.

Checkpoints: the tiny fused OpenVLA of tests/test_torch_load.py, exported by
the JAX package (fp32 safetensors) and loaded by both harnesses'
`InProcessVLA` with the decoder quantized to int8 on load and w8a8 on (the
harnesses' default), with the registries patched to the tiny configs under
the real ids and the towers' preprocessing at 32 px. The float leaves load
at fp32 (`fp32_loads`): bf16 on the CPU rounds differently in XLA and ATen,
which flips ids of a tiny random model, so the packages are compared at
fp32 as the other parity tests compare them (and the port-only tests load
fp32 too: bf16 matmuls on the CPU are slow).

Tolerances, and why:
* `preprocess_image`: 1e-6 on the [0, 1] image, before each tower's
  normalization divides by its std (fp32; the two resizes sum in another
  order).
* `crop_and_resize_eval`: 1e-5 (fp32 bicubic, the same).
* the uint8 crop frame: equal wherever the JAX value x * 255 lies inside
  [0, 255] and more than 255 * 1e-5 from a rounding boundary (a half
  integer), which the float tolerance can move; where the JAX cast wraps a
  value outside [0, 255] around, the port saturates (ROADMAP.md Queue 3).
* LIBERO actions: 1e-6, step for step, against the JAX harness's in greedy,
  speculative, remote and chunk modes on frames whose crop does not
  overshoot (smooth frames): the ids are equal, and the float32
  unnormalization sums in another order (7e-9 seen).
* WidowX helpers, `is_noop`, episode records: equal (numpy on both sides).
"""

import dataclasses
import io
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bridgelang_tpu.ops.image_ops as jimg
import bridgelang_tpu_torch.ops.image_ops as timg
from bridgelang_tpu_torch.experiments.robot import openvla_utils as t_ou
from bridgelang_tpu_torch.experiments.robot import robot_utils as t_ru
from bridgelang_tpu_torch.experiments.robot.bridge import widowx_env as t_wx
from bridgelang_tpu_torch.experiments.robot.libero import regenerate_libero_dataset as t_regen
from bridgelang_tpu_torch.experiments.robot.libero import run_libero_eval as t_libero
from experiments.robot import openvla_utils as j_ou
from experiments.robot.bridge import widowx_env as j_wx
from experiments.robot.libero import regenerate_libero_dataset as j_regen
from experiments.robot.libero import run_libero_eval as j_libero
from tests.test_torch_load import ckpts, patch_registries  # noqa: F401 (ckpts is a fixture)

FLOAT_TOL = 1e-5
TOWER_PX = 32
FRAME_PX = 48            # the fake simulator's camera
EPISODE_STEPS = 3        # policy steps before the fake task succeeds
CHUNK = 4                # action_chunk of the chunk mode


@pytest.fixture
def tiny(monkeypatch):
    """The tiny configs under the real ids, and the fused towers'
    preprocessing at 32 px, in both packages."""
    patch_registries(monkeypatch)
    for mod in (jimg, timg):
        for name in ("dinov2", "siglip"):
            monkeypatch.setitem(mod.TOWER_SPECS, name, dataclasses.replace(mod.TOWER_SPECS[name], size=TOWER_PX))


@pytest.fixture
def fp32_loads(monkeypatch):
    """Both packages' `load_vla` with fp32 float leaves (the harnesses'
    quantization flags untouched)."""
    import functools

    import jax.numpy as jnp_

    import bridgelang_tpu.models.load as jload
    import bridgelang_tpu_torch.models.load as tload

    monkeypatch.setattr(jload, "load_vla", functools.partial(jload.load_vla, dtype=jnp_.float32))
    monkeypatch.setattr(tload, "load_vla", functools.partial(tload.load_vla, dtype=torch.float32))


def _noise(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _smooth(h, w, t):
    """A frame whose values stay in [40, 215] and change slowly: its bicubic
    crop stays inside [0, 1]."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    chans = [127 + 60 * np.sin(0.11 * x + 0.07 * y + 0.9 * t + c) + 25 * np.cos(0.05 * y - 0.3 * t * c)
             for c in range(3)]
    return np.clip(np.stack(chans, -1), 40, 215).astype(np.uint8)


# --- image ops ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["resize-naive", "resize-crop", "letterbox"])
def test_preprocess_image_matches_jax(strategy):
    towers = ((40, jimg.IMAGENET_DEFAULT_MEAN, jimg.IMAGENET_DEFAULT_STD), (40, jimg.INCEPTION_MEAN, jimg.INCEPTION_STD))
    jcfg = jimg.ImageTransformConfig(strategy, tuple(jimg.ImageTowerSpec(*t) for t in towers))
    tcfg = timg.ImageTransformConfig(strategy, tuple(timg.ImageTowerSpec(*t) for t in towers))
    frame = _noise((48, 64, 3), seed=1)
    want = np.asarray(jimg.preprocess_image(jnp.asarray(frame), jcfg))
    got = timg.preprocess_image(torch.from_numpy(frame), tcfg)
    assert got.shape == want.shape == (6, 40, 40)
    # 1e-6 on the [0, 1] image: the normalization divides each side's
    # difference by the tower's std (as low as 0.229), so undo it first.
    std = np.concatenate([t[2] for t in towers], dtype=np.float32)[:, None, None]
    np.testing.assert_allclose(got.numpy() * std, want * std, atol=1e-6, rtol=0)
    batch = timg.preprocess_batch(torch.from_numpy(frame)[None], tcfg)
    np.testing.assert_array_equal(batch[0].numpy(), got.numpy())


@pytest.mark.parametrize("shape,scale", [((256, 256, 3), 0.9), ((48, 64, 3), 0.9), ((224, 224, 3), 0.5),
                                         ((33, 47, 3), 0.81)])
def test_crop_and_resize_eval_matches_jax(shape, scale):
    x = _noise(shape, seed=2).astype(np.float32) / 255.0
    want = np.asarray(jimg.crop_and_resize_eval(jnp.asarray(x), scale))
    got = timg.crop_and_resize_eval(torch.from_numpy(x), scale)
    assert got.shape == want.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=FLOAT_TOL, rtol=0)
    assert want.min() < 0 and want.max() > 1, "bicubic overshoots [0, 1] on noise"


def test_crop_frame_saturates_where_jax_wraps():
    """The harness's uint8 crop on a 256 x 256 noise frame: the JAX harness
    casts x * 255 with numpy (wrapping around), the port saturates."""
    frame = _noise((256, 256, 3), seed=0)
    x = frame.astype(np.float32) / 255.0
    j_float = np.asarray(j_ou.crop_and_resize(x)) * 255.0
    j_u8 = (j_float.round()).astype(np.uint8)  # the JAX harness's expression
    got = t_ou.crop_frame_u8(frame)
    assert got.dtype == np.uint8 and got.shape == frame.shape
    inside = (j_float.round() >= 0) & (j_float.round() <= 255)
    clear = inside & (np.abs(np.abs(j_float - np.floor(j_float)) - 0.5) > 255 * FLOAT_TOL)
    assert clear.mean() > 0.98
    np.testing.assert_array_equal(got[clear], j_u8[clear])
    below, above = j_float.round() < 0, j_float.round() > 255
    assert below.sum() > 0 and above.sum() > 0
    assert (got[below] == 0).all() and (got[above] == 255).all()
    assert (j_u8[below] > 128).all(), "the JAX cast wraps negative values around"


def test_harness_crop_equals_jax_without_overshoot():
    frame = _smooth(FRAME_PX, FRAME_PX, 0.0)
    x = frame.astype(np.float32) / 255.0
    j_float = np.asarray(j_ou.crop_and_resize(x))
    assert j_float.min() >= 0 and j_float.max() <= 1
    want = (j_float * 255.0).round().astype(np.uint8)
    got = t_ou.crop_frame_u8(frame)
    clear = np.abs(np.abs(j_float * 255.0 - np.floor(j_float * 255.0)) - 0.5) > 255 * FLOAT_TOL
    np.testing.assert_array_equal(got[clear], want[clear])
    assert (np.abs(got.astype(int) - want.astype(int)) <= 1).all()


# --- the LIBERO harness with a fake simulator -------------------------------------------------


class _Recorder:
    def __init__(self):
        self.actions, self.frames, self.episodes = [], [], 0


def install_fake_libero(monkeypatch, rec: _Recorder, n_tasks: int = 2, steps: int = EPISODE_STEPS):
    """A `libero` package in sys.modules: a suite of `n_tasks` tasks whose
    env renders smooth frames (upside down, as LIBERO does) and succeeds
    after `steps` policy steps; it records every policy action."""
    settle = t_libero.NUM_SETTLE_STEPS

    class FakeEnv:
        def __init__(self, bddl_file_name, camera_heights, camera_widths):
            self.h, self.w, self.steps, self.t = camera_heights, camera_widths, 0, 0.0

        def _obs(self):
            frame = _smooth(self.h, self.w, self.t)
            rec.frames.append(frame)
            return {"agentview_image": frame[::-1, ::-1]}

        def reset(self):
            self.steps = 0
            return self._obs()

        def set_init_state(self, state):
            rec.episodes += 1
            self.t = float(state[0])
            return self._obs()

        def step(self, action):
            self.steps += 1
            if self.steps > settle:
                rec.actions.append(np.asarray(action, np.float64))
                self.t += 0.25
            return self._obs(), 0.0, self.steps >= settle + steps, {}

        def close(self):
            pass

    class FakeTask:
        def __init__(self, i):
            self.language = ["put the bowl on the plate", "open the top drawer"][i % 2]
            self.name = f"task_{i}"

    class FakeSuite:
        def __init__(self):
            self.n_tasks = n_tasks

        def get_task(self, i):
            return FakeTask(i)

        def get_task_bddl_file_path(self, i):
            return f"task{i}.bddl"

        def get_task_init_states(self, i):
            return [np.array([0.5 * i]), np.array([0.5 * i + 0.2])]

    benchmark = types.ModuleType("libero.libero.benchmark")
    benchmark.get_benchmark_dict = lambda: {"libero_spatial": FakeSuite}
    envs = types.ModuleType("libero.libero.envs")
    envs.OffScreenRenderEnv = FakeEnv
    inner = types.ModuleType("libero.libero")
    inner.benchmark, inner.envs = benchmark, envs
    outer = types.ModuleType("libero")
    outer.libero = inner
    for name, mod in (("libero", outer), ("libero.libero", inner), ("libero.libero.benchmark", benchmark),
                      ("libero.libero.envs", envs)):
        monkeypatch.setitem(sys.modules, name, mod)


def _libero_cfg(module, path, tmp_path, mode, **kw):
    extra = {"speculative": mode == "speculative", "action_chunk": CHUNK if mode == "chunk" else 1}
    return module.LiberoEvalConfig(pretrained_checkpoint=str(path), task_suite_name="libero_spatial",
                                   num_trials_per_task=1, unnorm_key="bridge_orig", center_crop=True,
                                   resolution=FRAME_PX, local_log_dir=str(tmp_path / "logs"), **extra, **kw)


def _run_jax_harness(monkeypatch, path, tmp_path, mode, port=None):
    rec = _Recorder()
    install_fake_libero(monkeypatch, rec)
    kw = {"remote_host": "127.0.0.1", "remote_port": port} if port else {}
    j_libero.main(_libero_cfg(j_libero, path, tmp_path / "jax", mode, **kw))
    return rec


def _run_port_harness(monkeypatch, path, tmp_path, mode, port=None):
    rec = _Recorder()
    install_fake_libero(monkeypatch, rec)
    kw = {"remote_host": "127.0.0.1", "remote_port": port} if port else {"device": "cpu"}
    t_libero.main(_libero_cfg(t_libero, path, tmp_path / "port", mode, **kw))
    return rec


@pytest.mark.parametrize("mode", ["greedy", "speculative", "chunk", "remote"])
def test_libero_main_actions_equal_jax(ckpts, tiny, fp32_loads, monkeypatch, tmp_path, mode):
    """run_libero_eval.main of both packages over the same fake simulator
    and checkpoint: 2 tasks x 1 episode x 3 steps; every action the env
    receives (gripper normalized, binarized, inverted) equal. Remote: each
    harness against its own package's VLAServer on the int8 load."""
    path = ckpts["fused"][2]
    if mode == "remote":
        import bridgelang_tpu.models.load as jload
        import bridgelang_tpu_torch.models.load as tload
        from bridgelang_tpu.models.llm.tokenizer import ByteFallbackTokenizer as JTokenizer
        from bridgelang_tpu.serving.server import VLAServer as JServer
        from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
        from bridgelang_tpu_torch.serving.server import VLAServer

        jm, jp = jload.load_vla(str(path), quantize_int8=True)
        jm.tokenizer = JTokenizer()
        tm, tp = tload.load_vla(str(path), quantize_int8=True, device="cpu")
        tm.tokenizer = ByteFallbackTokenizer()
        servers = [JServer(jm, jp).serve_background(port=0), VLAServer(tm, tp, device="cpu").serve_background(port=0)]
        try:
            want = _run_jax_harness(monkeypatch, path, tmp_path, mode, port=servers[0].server_address[1])
            got = _run_port_harness(monkeypatch, path, tmp_path, mode, port=servers[1].server_address[1])
        finally:
            for s in servers:
                s.shutdown()
                s.server_close()
        local = _run_port_harness(monkeypatch, path, tmp_path, "greedy")
        np.testing.assert_array_equal(np.stack(got.actions), np.stack(local.actions))
    else:
        want = _run_jax_harness(monkeypatch, path, tmp_path, mode)
        got = _run_port_harness(monkeypatch, path, tmp_path, mode)
    assert got.episodes == want.episodes == 2
    assert len(got.actions) == len(want.actions) == 2 * EPISODE_STEPS
    np.testing.assert_allclose(np.stack(got.actions), np.stack(want.actions), atol=1e-6, rtol=0)
    assert len({tuple(a) for a in want.actions}) > 1, "the frames should move the actions"
    assert set(np.unique(np.stack(got.actions)[:, -1])) <= {-1.0, 1.0}
    log = next((tmp_path / "port" / "logs").glob("EVAL-*.txt")).read_text()
    assert "TOTAL success rate: 2/2 = 1.000" in log


def test_in_process_policy_modes_agree(ckpts, tiny, fp32_loads):
    """InProcessVLA on the CPU: each greedy action equals predict_action on
    the same cropped frame; speculative ticks give greedy's ids; a chunk of
    4 answers 4 ticks with one model pass, and a new episode fetches anew."""
    path = str(ckpts["fused"][2])
    greedy = t_ou.InProcessVLA(path, device="cpu")
    spec = t_ou.InProcessVLA(path, speculative=True, device="cpu")
    chunk = t_ou.InProcessVLA(path, action_chunk=CHUNK, device="cpu")
    calls = []
    real = chunk.model.predict_action_chunk
    chunk.model.predict_action_chunk = lambda *a, **k: calls.append(1) or real(*a, **k)
    for t in range(2 * CHUNK):
        obs = {"full_image": _smooth(FRAME_PX, FRAME_PX, 0.3 * t)}
        a = t_ou.get_vla_action(greedy, obs, "pick up the cup", "bridge_orig", center_crop=True)
        cropped = t_ou.crop_frame_u8(obs["full_image"])
        want, ids = greedy.model.predict_action_batch(greedy.params, [cropped], ["pick up the cup"], "bridge_orig",
                                                      return_tokens=True)
        np.testing.assert_array_equal(a, want[0])
        t_ou.get_vla_action(spec, obs, "pick up the cup", "bridge_orig", center_crop=True)
        np.testing.assert_array_equal(spec._last_tokens, ids[0])
        t_ou.get_vla_action(chunk, obs, "pick up the cup", "bridge_orig", center_crop=True)
    assert len(calls) == 2
    chunk.reset_episode()
    t_ou.get_vla_action(chunk, {"full_image": _smooth(FRAME_PX, FRAME_PX, 0.0)}, "pick up the cup", "bridge_orig")
    assert len(calls) == 3


def test_policy_defaults_to_cuda(ckpts, tiny):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ou.InProcessVLA(str(ckpts["fused"][2]))
    cfg = t_libero.LiberoEvalConfig(pretrained_checkpoint=str(ckpts["fused"][2]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ou.get_vla(cfg)
    assert isinstance(t_ou.get_vla(dataclasses.replace(cfg, remote_host="127.0.0.1")), t_ou.RemoteVLA)


def test_robot_utils_match_jax():
    from experiments.robot import robot_utils as j_ru

    a = np.array([[0.1, -0.2, 0.3, 0.0, 0.5, -0.5, 0.8], [0.0] * 6 + [0.2]])
    for binarize in (True, False):
        np.testing.assert_array_equal(t_ru.normalize_gripper_action(a, binarize),
                                      j_ru.normalize_gripper_action(a, binarize))
    np.testing.assert_array_equal(t_ru.invert_gripper_action(a), j_ru.invert_gripper_action(a))
    t_ru.set_seed_everywhere(3)
    x = (np.random.rand(), torch.rand(1).item())
    t_ru.set_seed_everywhere(3)
    assert (np.random.rand(), torch.rand(1).item()) == x
    assert t_ru.save_video([], "unused.mp4") is None


# --- WidowX / BridgeV2 ---------------------------------------------------------------------


class FakeWidowXClient:
    """A WidowXClient stand-in: [3, S, S] float images in [0, 1], an 8-D
    state; `lose_after` steps in, get_observation returns None once."""

    def __init__(self, im_size=32, lose_after=None):
        self.im_size, self.lose_after = im_size, lose_after
        self.n_steps, self.moves, self.actions, self.resets = 0, [], [], 0

    def init(self, env_params):
        self.env_params = env_params

    def get_observation(self):
        if self.lose_after is not None and self.n_steps == self.lose_after:
            self.lose_after = None
            return None
        t = 0.1 * self.n_steps
        y, x = np.mgrid[0:self.im_size, 0:self.im_size]
        img = np.stack([0.5 + 0.3 * np.sin(0.2 * x + t + c) * np.cos(0.1 * y) for c in range(3)])
        full = (_smooth(60, 80, t)).astype(np.uint8)
        return {"image": img.reshape(-1), "state": np.arange(7, dtype=np.float64) * 0.1 + t, "full_image": full}

    def step_action(self, action, blocking=False):
        self.actions.append((np.asarray(action), blocking))
        self.n_steps += 1

    def reset(self):
        self.resets += 1

    def move(self, transform, duration=0.8, blocking=True):
        self.moves.append((np.asarray(transform), duration, blocking))


def test_widowx_helpers_match_jax(monkeypatch):
    for xyz, z in (((0.3, -0.09, 0.26), 0.0), ((0.1, 0.2, 0.3), 0.7), ((0.0, 0.0, 0.1), -2.5)):
        np.testing.assert_array_equal(t_wx.state_to_eep(xyz, z), j_wx.state_to_eep(xyz, z))
    q = np.array([0.3, -0.2, 0.5, 0.1])
    np.testing.assert_array_equal(t_wx._quat_to_matrix(q), j_wx._quat_to_matrix(q))
    np.testing.assert_array_equal(t_wx._quat_mul(q, q[::-1]), j_wx._quat_mul(q, q[::-1]))
    for m in (t_wx._DEFAULT_ROTATION, t_wx._START_ROT, np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])):
        np.testing.assert_array_equal(t_wx._matrix_to_quat(m), j_wx._matrix_to_quat(m))
    raw = FakeWidowXClient().get_observation()
    for got, want in ((t_wx.convert_obs(raw, 32), j_wx.convert_obs(raw, 32)), (t_wx.null_obs(32), j_wx.null_obs(32))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype

    cfg = types.SimpleNamespace(init_ee_pos=(0.3, -0.09, 0.26))
    results = []
    for mod in (t_wx, j_wx):
        answers = iter(["", "0.25", "x", "0.31", "", ""])  # a bad entry: the prompt asks again
        monkeypatch.setattr("builtins.input", lambda *a: next(answers, ""))
        client = FakeWidowXClient(lose_after=1)
        env = mod.WidowXGym(client, cfg, im_size=32, blocking=False)
        obs, _ = env.reset()
        step1 = env.step(np.ones(7))
        step2 = env.step(np.zeros(7))
        results.append((client, obs, step1, step2))
    (tc, tobs, t1, t2), (jc, jobs, j1, j2) = results
    np.testing.assert_array_equal(tc.moves[0][0], jc.moves[0][0])
    np.testing.assert_array_equal(tc.moves[0][0][:3, 3], [0.31, -0.09, 0.26])
    assert tc.moves[0][2] is True and tc.actions[0][1] is False
    assert t1[3] is j1[3] is True and t2[3] is j2[3] is False  # the lost connection truncates once
    for a, b in ((tobs, jobs), (t1[0], j1[0]), (t2[0], j2[0])):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def _install_fake_widowx(monkeypatch, clients):
    service = types.ModuleType("widowx_envs.widowx_env_service")

    class WidowXConfigs:
        DefaultEnvParams = {"fix_zangle": 0.1, "move_duration": 0.2}

    def WidowXClient(host, port):
        c = FakeWidowXClient(im_size=32)
        clients.append(c)
        return c

    service.WidowXConfigs, service.WidowXClient = WidowXConfigs, WidowXClient
    pkg = types.ModuleType("widowx_envs")
    pkg.widowx_env_service = service
    monkeypatch.setitem(sys.modules, "widowx_envs", pkg)
    monkeypatch.setitem(sys.modules, "widowx_envs.widowx_env_service", service)


def test_bridge_main_runs_with_fake_widowx(ckpts, tiny, fp32_loads, monkeypatch, tmp_path):
    """run_bridgev2_eval.main over a fake WidowX stack and stubbed prompts,
    2 episodes of 3 steps with the in-process policy on the CPU: every step
    sends predict_action's action for that step's frame, non-blocking; the
    npz rollouts hold them. center_crop on is refused."""
    from bridgelang_tpu_torch.experiments.robot.bridge import run_bridgev2_eval as t_bridge

    clients = []
    _install_fake_widowx(monkeypatch, clients)
    prompts = iter(["stack the cups"])  # then Enter at every prompt: repeat the task, default pose, go
    monkeypatch.setattr("builtins.input", lambda *a: next(prompts, ""))
    seen = []
    real_predict = t_ou.InProcessVLA.predict
    monkeypatch.setattr(t_ou.InProcessVLA, "predict",
                        lambda self, img, instr, key: seen.append((self, img, instr, key)) or real_predict(self, img, instr, key))
    cfg = t_bridge.BridgeEvalConfig(pretrained_checkpoint=str(ckpts["fused"][2]), max_episodes=2, max_steps=3,
                                    control_frequency=50.0, resize_hw=32, save_data=True,
                                    rollout_dir=str(tmp_path / "rollouts"), device="cpu")
    t_bridge.main(cfg)
    client = clients[0]
    assert client.env_params["return_full_image"] is True and len(client.moves) == 2
    assert len(client.actions) == len(seen) == 6 and all(b is False for _, b in client.actions)
    vla = seen[0][0]
    for (a, _), (_, img, instr, key) in zip(client.actions, seen):
        assert instr == "stack the cups" and key == "bridge_orig" and img.shape == (32, 32, 3)
        np.testing.assert_array_equal(a, vla.model.predict_action(vla.params, img, instr, unnorm_key=key))
    saved = sorted((tmp_path / "rollouts").glob("*.npz"))
    assert len(saved) == 2 and np.load(saved[0])["actions"].shape == (3, 7)
    with pytest.raises(AssertionError, match="center_crop"):
        t_bridge.main(dataclasses.replace(cfg, center_crop=True))


# --- LIBERO regeneration -----------------------------------------------------------------


def test_is_noop_and_episode_records_match_jax():
    cases = [(np.zeros(7), None), (np.array([0.0] * 6 + [1.0]), np.array([0.0] * 6 + [1.0])),
             (np.array([0.0] * 6 + [1.0]), np.array([0.0] * 6 + [-1.0])), (np.array([1e-5] * 6 + [-1.0]), None),
             (np.array([1e-3] + [0.0] * 5 + [-1.0]), np.array([0.0] * 6 + [-1.0]))]
    for a, prev in cases:
        assert t_regen.is_noop(a, prev) == j_regen.is_noop(a, prev)
    rng = np.random.default_rng(5)
    steps = [{"image": rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
              "wrist_image": rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
              "state": rng.normal(size=9), "joint_state": rng.normal(size=7), "action": rng.normal(size=7)}
             for _ in range(3)]
    got = np.load(io.BytesIO(t_regen._serialize_episode(steps, "put the bowl on the stove")))
    want = np.load(io.BytesIO(j_regen._serialize_episode(steps, "put the bowl on the stove")))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_regenerate_main_matches_jax(monkeypatch, tmp_path):
    """Both packages' regenerate main over one fake HDF5 demo file and a
    fake replay env: the same records (no-ops skipped, the failed replay
    dropped), meta.json and metainfo."""
    h5py = pytest.importorskip("h5py")
    from bridgelang_tpu import native as j_native
    from bridgelang_tpu_torch import native as t_native

    rng = np.random.default_rng(7)
    raw = tmp_path / "raw"
    raw.mkdir()
    with h5py.File(raw / "task_0_demo.hdf5", "w") as f:
        for d, n in (("demo_0", 6), ("demo_1", 4)):
            acts = rng.normal(size=(n, 7)) * 0.1
            acts[1] = [0.0] * 6 + [acts[0, -1]]  # a no-op: still, gripper unchanged
            f.create_dataset(f"data/{d}/actions", data=acts)
            f.create_dataset(f"data/{d}/states", data=rng.normal(size=(n, 5)) + (d == "demo_1") * 10)

    class ReplayEnv:
        def __init__(self, bddl_file_name, camera_heights, camera_widths):
            self.hw, self.n = camera_heights, 0

        def reset(self):
            self.n = 0

        def set_init_state(self, state):
            self.fail = state[0] > 5  # demo_1's replay fails

        def step(self, action):
            self.n += 1
            v = np.uint8(self.n % 250)
            obs = {"agentview_image": np.full((self.hw, self.hw, 3), v), "robot0_eye_in_hand_image":
                   np.full((self.hw, self.hw, 3), 255 - v), "robot0_eef_pos": np.full(3, 0.1 * self.n),
                   "robot0_eef_quat": np.ones(4), "robot0_gripper_qpos": np.zeros(2),
                   "robot0_joint_pos": np.arange(7.0)}
            obs["agentview_image"][0, 0] = 0  # a marker the flip moves
            return obs, 0.0, (not self.fail) and self.n > 10, {}

        def close(self):
            pass

    class Suite:
        n_tasks = 1

        def get_task(self, i):
            return types.SimpleNamespace(name="task_0", language="pick up the cup")

        def get_task_bddl_file_path(self, i):
            return "task.bddl"

    rec = _Recorder()
    install_fake_libero(monkeypatch, rec)
    sys.modules["libero.libero.benchmark"].get_benchmark_dict = lambda: {"libero_spatial": Suite}
    sys.modules["libero.libero.envs"].OffScreenRenderEnv = ReplayEnv
    out = {}
    for name, mod, native in (("jax", j_regen, j_native), ("port", t_regen, t_native)):
        mod.main(mod.RegenConfig(libero_raw_data_dir=str(raw), out_dir=str(tmp_path / name), resolution=16))
        root = tmp_path / name / "libero_spatial_no_noops"
        records = list(native.read_tfrecords(str(root / "task00.tfrecord")))
        out[name] = ([np.load(io.BytesIO(r)) for r in records], (root / "meta.json").read_text(),
                     (root / "libero_spatial_metainfo.json").read_text())
    (jr, jmeta, jinfo), (tr, tmeta, tinfo) = out["jax"], out["port"]
    assert tmeta == jmeta and tinfo == jinfo and len(tr) == len(jr) == 1
    assert '"noops_dropped": 2' in tmeta and '"successes": 1' in tmeta
    for k in jr[0].files:
        np.testing.assert_array_equal(tr[0][k], jr[0][k])
    assert tr[0]["images"].shape == (5, 16, 16, 3)
