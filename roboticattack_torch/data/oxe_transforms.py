"""Open-X-Embodiment per-dataset standardization transforms (tf.data, host CPU).

Behavioral port of the reference's transform registry
(prismatic/vla/datasets/rlds/oxe/transforms.py:31-922 and
oxe/utils/droid_utils.py). Every transform maps a raw TFDS trajectory dict to
the standardized layout:

    observation: {<image keys>, <state keys>}
    action:      [T, 7] float32 = EEF delta xyz + delta rpy + ABSOLUTE gripper
                 in [0, 1] with +1 = open, 0 = closed
    language_instruction: [T] tf.string

Instead of ~60 hand-written near-duplicate functions, the common shapes are
expressed with a small combinator set: gripper-column post-processors, a
dict-action builder (world_vector/rotation_delta family), a flat-action
builder (slice-first-6 family), padded-action builders, and observation
aliasing. Each registry entry cites the reference lines whose behavior it
reproduces. Quaternion->euler conversion is implemented in plain tf (the
reference pulls in tensorflow_graphics, which is not a dependency here).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from .rlds import (
    _tf,
    binarize_gripper_actions,
    bridge_orig_transform,
    invert_gripper_actions,
    libero_transform,
    rel2abs_gripper_actions,
    relabel_bridge_actions,
)

Transform = Callable[[Dict], Dict]


def quat_xyzw_to_euler(quat):
    """[..., 4] xyzw quaternion -> [..., 3] x-y-z Euler angles, matching
    tensorflow_graphics euler.from_quaternion away from the gimbal-lock poles
    (used for furniture_bench / iamlab / cmu_playing_with_food rotations)."""
    tf = _tf()
    x, y, z, w = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    roll = tf.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = tf.asin(tf.clip_by_value(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = tf.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return tf.stack([roll, pitch, yaw], axis=-1)


# --- gripper-column post-processors -------------------------------------------------
# Each takes the raw gripper signal ([T] or [T, k]) and returns a [T, 1]
# float32 column in the standardized +1 = open / 0 = closed convention.

def _as_col(x):
    return x[:, None] if x.shape.ndims == 1 else x[:, -1:]


def g_rel2abs(x):
    """Relative open/close impulses -> absolute state (rt1/kuka/jaco/ur5...)."""
    x = x[:, 0] if x.shape.ndims == 2 else x
    return rel2abs_gripper_actions(x)[:, None]


def g_binarize(x):
    x = x[:, -1] if x.shape.ndims == 2 else x
    return binarize_gripper_actions(x)[:, None]


def g_clip(x):
    tf = _tf()
    return tf.clip_by_value(_as_col(x), 0.0, 1.0)


def g_invert_clip(x):
    return invert_gripper_actions(g_clip(x))


def g_invert(x):
    return invert_gripper_actions(_as_col(x))


def g_cast(x):
    tf = _tf()
    return tf.cast(_as_col(x), tf.float32)


def g_raw(x):
    return _as_col(x)


# --- transform combinators -----------------------------------------------------------

def compose(*fns: Transform) -> Transform:
    def run(traj):
        for f in fns:
            traj = f(traj)
        return traj

    return run


def drop_first_step(traj: Dict) -> Dict:
    """Remove timestep 0 from every (nested) feature except traj_metadata —
    bridge datasets store an all-zero action there (transforms.py:35-44)."""
    tf = _tf()
    return {
        k: (v if k == "traj_metadata" else tf.nest.map_structure(lambda x: x[1:], v))
        for k, v in traj.items()
    }


def language_from_obs(key: str = "natural_language_instruction") -> Transform:
    def run(traj):
        traj["language_instruction"] = traj["observation"][key]
        return traj

    return run


def alias_obs(**aliases) -> Transform:
    """observation[name] = <source>[:, slice]. The source is an observation
    key, or '<top>:<sub>' to read a nested top-level trajectory key (asu reads
    trajectory['ground_truth_states']['EE'], transforms.py:624)."""

    def run(traj):
        for name, (src, sl) in aliases.items():
            if ":" in src:
                top, sub = src.split(":", 1)
                val = traj[top][sub]
            else:
                val = traj["observation"][src]
            traj["observation"][name] = val if sl is None else val[:, sl]
        return traj

    return run


def dict_action(
    gripper: Optional[Callable],
    gripper_key: str = "gripper_closedness_action",
    rot: Optional[str] = "rotation_delta",
    xyz: str = "world_vector",
) -> Transform:
    """action dict {world_vector, rotation_delta, gripper...} -> [T, 7]
    (the rt1-style family, transforms.py:102-116 etc.). rot=None pads the
    rotation with zeros (jaco_play, :175-182); gripper=None pads with a zero
    column (berkeley_cable_routing, :188-195)."""

    def run(traj):
        tf = _tf()
        act = traj["action"]
        delta_xyz = act[xyz]
        delta_rot = act[rot] if rot is not None else tf.zeros_like(delta_xyz)
        grip = gripper(act[gripper_key]) if gripper is not None else tf.zeros_like(delta_xyz[:, :1])
        traj["action"] = tf.concat([delta_xyz, delta_rot, grip], axis=-1)
        return traj

    return run


def flat_action(gripper: Callable) -> Transform:
    """Flat [T, >=7] action -> first 6 dims + standardized gripper column from
    the last raw column (the austin/libero/hydra family)."""

    def run(traj):
        tf = _tf()
        traj["action"] = tf.concat(
            [traj["action"][:, :6], gripper(traj["action"][:, -1:])], axis=-1
        )
        return traj

    return run


def pad_action(keep: int, zeros: int, tail: str = "last") -> Transform:
    """[T, *] action -> first `keep` dims, `zeros` zero-padded dims, then the
    raw last column ('last'), a zero ('zero'), or a one ('one') gripper."""

    def run(traj):
        tf = _tf()
        a = traj["action"]
        pad = tf.zeros_like(tf.tile(a[:, :1], [1, zeros])) if zeros else a[:, :0]
        tails = {"last": a[:, -1:], "zero": tf.zeros_like(a[:, :1]),
                 "one": tf.ones_like(a[:, :1])}
        traj["action"] = tf.concat([a[:, :keep], pad, tails[tail]], axis=-1)
        return traj

    return run


def slice_action(sl) -> Transform:
    def run(traj):
        traj["action"] = traj["action"][..., sl]
        return traj

    return run


def quat_action(gripper: Callable, gripper_slice=slice(-1, None)) -> Transform:
    """[T, 3 xyz + 4 quat + ...] -> xyz + euler rpy + gripper column
    (furniture_bench :432-439, iamlab :645-652, cmu_playing_with_food
    :704-711; quaternions converted without tensorflow_graphics)."""

    def run(traj):
        tf = _tf()
        a = traj["action"]
        traj["action"] = tf.concat(
            [a[:, :3], quat_xyzw_to_euler(a[:, 3:7]), gripper(a[:, gripper_slice])], axis=-1
        )
        return traj

    return run


def obs_slice(key: str, sl) -> Transform:
    def run(traj):
        traj["observation"][key] = traj["observation"][key][..., sl]
        return traj

    return run


# --- per-dataset specifics that don't reduce to a combinator --------------------------

def _bridge_oxe(traj):
    """OXE-bucket Bridge V2 (transforms.py:31-58): drop the zero-action first
    step, dict action with cast open_gripper, state-delta relabel, EEF aliases."""
    traj = drop_first_step(traj)
    traj = dict_action(g_cast, gripper_key="open_gripper")(traj)
    traj = language_from_obs()(traj)
    traj = relabel_bridge_actions(traj)
    return alias_obs(
        EEF_state=("state", slice(None, 6)), gripper_state=("state", slice(-1, None))
    )(traj)


def _bridge_orig(traj):
    """Project-website Bridge V2 (transforms.py:61-86); extends the core
    transform in rlds.py with the EEF/gripper state aliases."""
    traj = bridge_orig_transform(traj)
    return alias_obs(
        EEF_state=("state", slice(None, 6)), gripper_state=("state", slice(-1, None))
    )(traj)


def _libero(traj):
    """LIBERO *_no_noops (transforms.py:827-841); gripper_state is 2-wide."""
    traj = libero_transform(traj)
    return alias_obs(
        EEF_state=("state", slice(None, 6)), gripper_state=("state", slice(-2, None))
    )(traj)


def _kuka(traj):
    """kuka (transforms.py:119-146): rt1-style action + ZLIB-compressed state
    tensors decoded in place."""
    tf = _tf()
    traj = dict_action(g_rel2abs)(traj)

    def unzlib(raw, width):
        flat = tf.io.decode_raw(tf.io.decode_compressed(raw, compression_type="ZLIB"), tf.float32)
        return tf.reshape(flat, (-1, width))

    obs = traj["observation"]
    obs["clip_function_input/base_pose_tool_reached"] = unzlib(
        obs["clip_function_input/base_pose_tool_reached"], 7
    )
    obs["gripper_closed"] = unzlib(obs["gripper_closed"], 1)
    return language_from_obs()(traj)


def _taco_play(traj):
    """taco_play (transforms.py:149-164)."""
    tf = _tf()
    traj = alias_obs(
        state_eef=("robot_obs", slice(None, 6)), state_gripper=("robot_obs", slice(7, 8))
    )(traj)
    a = traj["action"]["rel_actions_world"]
    traj["action"] = tf.concat([a[:, :6], tf.clip_by_value(a[:, -1:], 0.0, 1.0)], axis=-1)
    return language_from_obs()(traj)


def _berkeley_autolab_ur5(traj):
    """berkeley_autolab_ur5 (transforms.py:263-280): robot_state slice + the
    image_with_depth rename, then the rt1-style action build."""
    traj["observation"]["state"] = traj["observation"]["robot_state"][:, 6:14]
    traj["observation"]["depth"] = traj["observation"].pop("image_with_depth")
    return _rt1(traj)


def _language_table(traj):
    """language_table (transforms.py:299-316): 2-dof action padded to 7 with
    open gripper; instruction stored as zero-padded unicode code points."""
    tf = _tf()
    a = traj["action"]
    traj["action"] = tf.concat(
        [a, tf.zeros_like(a), tf.zeros_like(a), tf.ones_like(a[:, :1])], axis=-1
    )
    encoded = tf.strings.unicode_encode(traj["observation"]["instruction"], output_encoding="UTF-8")
    traj["language_instruction"] = tf.strings.split(encoded, "\x00")[:, :1].to_tensor()[:, 0]
    return traj


def _hydra(traj):
    """stanford_hydra (transforms.py:352-373): eef_state stitched from two
    state slices; 1-wide gripper state at -3."""
    tf = _tf()
    traj = flat_action(g_invert)(traj)
    s = traj["observation"]["state"]
    traj["observation"]["eef_state"] = tf.concat([s[:, :3], s[:, 7:10]], axis=-1)
    traj["observation"]["gripper_state"] = s[:, -3:-2]
    return traj


def _nyu_franka_play(traj):
    """nyu_franka_play (transforms.py:393-412)."""
    tf = _tf()
    obs = traj["observation"]
    obs["depth"] = tf.cast(obs["depth"][..., 0], tf.float32)
    obs["depth_additional_view"] = tf.cast(obs["depth_additional_view"][..., 0], tf.float32)
    obs["eef_state"] = obs["state"][:, -6:]
    a = traj["action"]
    traj["action"] = tf.concat([a[:, -8:-2], tf.clip_by_value(a[:, -2:-1], 0.0, 1.0)], axis=-1)
    return traj


def _furniture_bench(traj):
    """furniture_bench (transforms.py:420-440)."""
    tf = _tf()
    s = traj["observation"]["state"]
    traj["observation"]["state"] = tf.concat([s[:, :7], s[:, -1:]], axis=-1)
    return quat_action(g_invert_clip)(traj)


def _bc_z(traj):
    """bc_z (transforms.py:500-510)."""
    tf = _tf()
    a = traj["action"]
    traj["action"] = tf.concat(
        [
            a["future/xyz_residual"][:, :3],
            a["future/axis_angle_residual"][:, :3],
            invert_gripper_actions(tf.cast(a["future/target_close"][:, :1], tf.float32)),
        ],
        axis=-1,
    )
    return language_from_obs()(traj)


def _robo_net_style(pose_key: str):
    """robo_net / stanford_mask_vit (transforms.py:536-553, 576-593): 4-dof
    action and state padded with two zero rotation dims before the gripper."""

    def run(traj):
        tf = _tf()
        obs = traj["observation"]
        src = obs[pose_key]
        obs["eef_state"] = tf.concat([src[:, :4], tf.zeros_like(src[:, :2])], axis=-1)
        obs["gripper_state"] = src[:, -1:]
        a = traj["action"]
        traj["action"] = tf.concat([a[:, :4], tf.zeros_like(a[:, :2]), a[:, -1:]], axis=-1)
        return traj

    return run


def _kaist(traj):
    """kaist_nonprehensile (transforms.py:564-573): zero gripper column."""
    tf = _tf()
    traj["observation"]["state"] = traj["observation"]["state"][:, -7:]
    a = traj["action"]
    traj["action"] = tf.concat([a[:, :6], tf.zeros_like(a[:, :1])], axis=-1)
    return traj


def _berkeley_fanuc(traj):
    """berkeley_fanuc_manipulation (transforms.py:686-698): no gripper action
    recorded -> derive it from inverted gripper state."""
    tf = _tf()
    obs = traj["observation"]
    obs["joint_state"] = obs["state"][:, :6]
    obs["gripper_state"] = obs["state"][:, 6:7]
    traj["action"] = tf.concat(
        [traj["action"], invert_gripper_actions(obs["gripper_state"])], axis=-1
    )
    return traj


def _playfusion(traj):
    """cmu_play_fusion (transforms.py:715-723)."""
    tf = _tf()
    a = traj["action"]
    traj["action"] = tf.concat([a[:, :3], a[:, -4:]], axis=-1)
    return traj


def _cmu_stretch(traj):
    """cmu_stretch (transforms.py:726-736)."""
    tf = _tf()
    s = traj["observation"]["state"]
    traj["observation"]["eef_state"] = tf.concat([s[:, :3], tf.zeros_like(s[:, :3])], axis=-1)
    traj["observation"]["gripper_state"] = s[:, -1:]
    traj["action"] = traj["action"][..., :-1]
    return traj


def _gnm(traj):
    """berkeley_gnm_* navigation (transforms.py:739-757): 2-dof action padded
    to 7 with zeros; position/yaw packed into state."""
    tf = _tf()
    obs = traj["observation"]
    obs["state"] = tf.concat(
        [obs["position"], tf.zeros_like(obs["state"][:, :3]), obs["yaw"]], axis=-1
    )
    a = traj["action"]
    traj["action"] = tf.concat(
        [a, tf.zeros_like(a), tf.zeros_like(a), tf.zeros_like(a[:, :1])], axis=-1
    )
    return traj


def _uiuc_d3field(traj):
    """uiuc_d3field (transforms.py:656-665): 3-dof action, zero rot + gripper."""
    tf = _tf()
    a = traj["action"]
    traj["action"] = tf.concat([a, tf.zeros_like(a), tf.zeros_like(a[:, :1])], axis=-1)
    return traj


def _fmb(traj):
    """fmb_dataset (transforms.py:760-769)."""
    tf = _tf()
    obs = traj["observation"]
    obs["proprio"] = tf.concat([obs["eef_pose"], obs["state_gripper_pose"][..., None]], axis=-1)
    return traj


def _rh20t(traj):
    """rh20t (transforms.py:796-811)."""
    tf = _tf()
    a = traj["action"]
    traj["action"] = tf.concat([a["tcp_base"], tf.cast(a["gripper"][:, None], tf.float32)], axis=-1)
    obs = traj["observation"]
    obs["proprio"] = tf.concat([obs["tcp_base"], obs["gripper_width"][..., None]], axis=-1)
    return traj


def _roboset(traj):
    """roboset (transforms.py:778-793): 7-dof joint action + flipped gripper."""
    tf = _tf()
    traj["observation"]["proprio"] = traj["observation"]["state"]
    a = traj["action"]
    grip = invert_gripper_actions(tf.clip_by_value(a[:, -1:], 0.0, 1.0))
    traj["action"] = tf.concat([a[:, :7], grip], axis=-1)
    return traj


def _droid_base(traj):
    """droid / droid_wipe (droid_utils.py:127-148): base-frame cartesian
    velocity + inverted gripper position."""
    tf = _tf()
    vel = traj["action_dict"]["cartesian_velocity"]
    traj["action"] = tf.concat(
        [vel[:, :3], vel[:, 3:6], 1.0 - traj["action_dict"]["gripper_position"]], axis=-1
    )
    obs = traj["observation"]
    obs["proprio"] = tf.concat([obs["cartesian_position"], obs["gripper_position"]], axis=-1)
    return traj


def _droid_train(traj):
    """droid training variant (droid_utils.py:60-93): base action transform
    plus a per-trajectory random swap of the two exterior views."""
    tf = _tf()
    traj = _droid_base(traj)
    obs = traj["observation"]
    img1, img2 = obs["exterior_image_1_left"], obs["exterior_image_2_left"]
    swap = tf.random.uniform(shape=[]) > 0.5
    obs["exterior_image_1_left"] = tf.cond(swap, lambda: img1, lambda: img2)
    obs["exterior_image_2_left"] = tf.cond(swap, lambda: img2, lambda: img1)
    return traj


def droid_zero_action_filter(traj: Dict):
    """Keep chunks whose first 6 normalized action dims differ from the
    normalized zero action (droid_utils.py:151-179; the q01/q99 constants are
    DROID dataset statistics, reproduced verbatim as behavior)."""
    tf = _tf()
    q01 = tf.constant(
        [-0.7776297926902771, -0.5803514122962952, -0.5795090794563293,
         -0.6464047729969025, -0.7041108310222626, -0.8895104378461838]
    )
    q99 = tf.constant(
        [0.7597932070493698, 0.5726242214441299, 0.7351000607013702,
         0.6705610305070877, 0.6464948207139969, 0.8897542208433151]
    )
    norm_zero = 2.0 * (tf.zeros_like(traj["action"][:, :6]) - q01) / (q99 - q01 + 1e-8) - 1.0
    return tf.reduce_any(tf.math.abs(traj["action"][:, :6] - norm_zero) > 1e-5)


def identity_transform(traj: Dict) -> Dict:
    """Datasets already in the standardized layout (utokyo_xarm_pick_place,
    berkeley_mvp/rpt, dlr_sara_pour; transforms.py:527-528, 556-561, 602-603)."""
    return traj


# --- assembled registry ---------------------------------------------------------------

def _eef6():
    """eef_state = state[:, :6], gripper_state = state[:, -1:] — the most
    common observation aliasing (nyu_rot, ucsd, utokyo_pr2, lsmo, robocook...)."""
    return alias_obs(eef_state=("state", slice(None, 6)),
                     gripper_state=("state", slice(-1, None)))


_rt1 = compose(dict_action(g_rel2abs), language_from_obs())          # transforms.py:102-116

_ppgm = compose(                                                      # transforms.py:89-99, 814-824
    flat_action(g_binarize),
    alias_obs(EEF_state=("cartesian_position", slice(None, 6)),
              gripper_state=("gripper_position", slice(-1, None))),
)

OXE_TRANSFORMS: Dict[str, Transform] = {
    "bridge_oxe": _bridge_oxe,
    "bridge_orig": _bridge_orig,
    "bridge_dataset": _bridge_orig,
    "ppgm": _ppgm,
    "ppgm_static": _ppgm,
    "ppgm_wrist": _ppgm,
    "fractal20220817_data": _rt1,
    "kuka": _kuka,
    "taco_play": _taco_play,
    "jaco_play": compose(                                             # transforms.py:167-184
        alias_obs(state_eef=("end_effector_cartesian_pos", slice(None, 6)),
                  state_gripper=("end_effector_cartesian_pos", slice(-1, None))),
        dict_action(g_rel2abs, rot=None),
        language_from_obs(),
    ),
    "berkeley_cable_routing": compose(dict_action(None), language_from_obs()),   # :187-200
    "roboturk": compose(dict_action(g_invert_clip), language_from_obs()),        # :203-219
    "nyu_door_opening_surprising_effectiveness": _rt1,                           # :222-239
    "viola": compose(dict_action(g_invert_clip), language_from_obs()),           # :242-260
    "berkeley_autolab_ur5": _berkeley_autolab_ur5,
    "toto": compose(dict_action(g_cast, gripper_key="open_gripper"),
                    language_from_obs()),                                        # :283-296
    "language_table": _language_table,
    "columbia_cairlab_pusht_real": compose(dict_action(g_raw), language_from_obs()),  # :319-329
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": compose(    # :332-342
        obs_slice("depth_image", 0), pad_action(keep=3, zeros=3)),
    "nyu_rot_dataset_converted_externally_to_rlds": compose(                     # :345-349
        _eef6(), slice_action(slice(None, 7))),
    "stanford_hydra_dataset_converted_externally_to_rlds": _hydra,
    "austin_buds_dataset_converted_externally_to_rlds": compose(                 # :376-390
        flat_action(g_invert_clip), obs_slice("state", slice(None, 8))),
    "nyu_franka_play_dataset_converted_externally_to_rlds": _nyu_franka_play,
    "maniskill_dataset_converted_externally_to_rlds":
        alias_obs(gripper_state=("state", slice(7, 8))),                         # :415-417
    "furniture_bench_dataset_converted_externally_to_rlds": _furniture_bench,
    "cmu_franka_exploration_dataset_converted_externally_to_rlds":
        slice_action(slice(None, -1)),                                           # :443-445
    "ucsd_kitchen_dataset_converted_externally_to_rlds": compose(                # :448-451
        alias_obs(joint_state=("state", slice(None, 7))), slice_action(slice(None, -1))),
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": compose(         # :454-465
        _eef6(), pad_action(keep=3, zeros=3)),
    "austin_sailor_dataset_converted_externally_to_rlds": flat_action(g_invert_clip),  # :468-481
    "austin_sirius_dataset_converted_externally_to_rlds": flat_action(g_invert_clip),  # :484-497
    "bc_z": _bc_z,
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": compose(           # :513-517
        _eef6(), slice_action(slice(None, -1))),
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": compose(    # :520-524
        _eef6(), slice_action(slice(None, -1))),
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": identity_transform,
    "utokyo_xarm_bimanual_converted_externally_to_rlds": slice_action(slice(-7, None)),  # :531-533
    "robo_net": _robo_net_style("state"),
    "berkeley_mvp_converted_externally_to_rlds": identity_transform,
    "berkeley_rpt_converted_externally_to_rlds": identity_transform,
    "kaist_nonprehensile_converted_externally_to_rlds": _kaist,
    "stanford_mask_vit_converted_externally_to_rlds": _robo_net_style("end_effector_pose"),
    "tokyo_u_lsmo_converted_externally_to_rlds": _eef6(),                        # :596-599
    "dlr_sara_pour_converted_externally_to_rlds": identity_transform,
    "dlr_sara_grid_clamp_converted_externally_to_rlds":
        obs_slice("state", slice(None, 6)),                                      # :606-608
    "dlr_edan_shared_control_converted_externally_to_rlds": flat_action(g_invert),  # :611-620
    "asu_table_top_converted_externally_to_rlds": alias_obs(                     # :623-626
        eef_state=("ground_truth_states:EE", None),
        gripper_state=("state", slice(-1, None))),
    "stanford_robocook_converted_externally_to_rlds": _eef6(),                   # :629-632
    "imperialcollege_sawyer_wrist_cam": slice_action(slice(None, -1)),           # :635-637
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": compose(            # :640-653
        alias_obs(joint_state=("state", slice(None, 7)),
                  gripper_state=("state", slice(7, 8))),
        quat_action(g_raw, gripper_slice=slice(7, 8))),
    "uiuc_d3field": _uiuc_d3field,
    "utaustin_mutex": compose(                                                   # :668-683
        obs_slice("state", slice(None, 8)), flat_action(g_invert_clip)),
    "berkeley_fanuc_manipulation": _berkeley_fanuc,
    "cmu_playing_with_food": quat_action(g_raw),                                 # :701-712
    "cmu_play_fusion": _playfusion,
    "cmu_stretch": _cmu_stretch,
    "berkeley_gnm_recon": _gnm,
    "berkeley_gnm_cory_hall": _gnm,
    "berkeley_gnm_sac_son": _gnm,
    "droid": _droid_train,
    "fmb_dataset": _fmb,
    "dobbe": alias_obs(proprio=("state", None)),                                 # :772-775
    "roboset": _roboset,
    "rh20t": _rh20t,
    "tdroid_carrot_in_bowl": _ppgm,
    "tdroid_pour_corn_in_pot": _ppgm,
    "tdroid_flip_pot_upright": _ppgm,
    "tdroid_move_object_onto_plate": _ppgm,
    "tdroid_knock_object_over": _ppgm,
    "tdroid_cover_object_with_towel": _ppgm,
    "droid_wipe": _droid_base,
    "libero_spatial_no_noops": _libero,
    "libero_object_no_noops": _libero,
    "libero_goal_no_noops": _libero,
    "libero_10_no_noops": _libero,
}
