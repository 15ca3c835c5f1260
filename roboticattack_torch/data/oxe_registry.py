"""Open-X-Embodiment dataset registry: per-dataset keys/encodings + mixtures.

Structural equivalent of prismatic/vla/datasets/rlds/oxe/{configs,mixtures,
materialize}.py at full breadth: every dataset config the reference registers
(configs.py:54-673), every standardization transform (via oxe_transforms.py),
and every named mixture with its sampling weights (mixtures.py:11-209). The
key names, encodings, and weights are the reference's behavioral constants;
the registry machinery (frozen dataclass + registration function + compact
builder) is this repo's own.

`make_oxe_dataset_kwargs` reproduces the normalization contract: EEF_POS
actions normalize dims 0-5 and keep the gripper absolute; EEF_R6 normalizes
dims 0-8 (oxe/materialize.py:37-42).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .rlds import STANDARDIZATION_TRANSFORMS

logger = logging.getLogger(__name__)


class StateEncoding:
    """Proprio layout tags (configs.py:33-40)."""

    NONE = -1
    POS_EULER = 1
    POS_QUAT = 2
    JOINT = 3
    JOINT_BIMANUAL = 4


class ActionEncoding:
    """Action layout tags (configs.py:44-50)."""

    EEF_POS = 1
    JOINT_POS = 2
    JOINT_POS_BIMANUAL = 3
    EEF_R6 = 4


@dataclass(frozen=True)
class OXEDatasetConfig:
    image_obs_keys: Dict[str, Optional[str]]
    state_obs_keys: List[Optional[str]]
    state_encoding: int = StateEncoding.POS_EULER
    action_encoding: int = ActionEncoding.EEF_POS
    depth_obs_keys: Dict[str, Optional[str]] = field(
        default_factory=lambda: {"primary": None, "secondary": None, "wrist": None}
    )
    aux_kwargs: Dict = field(default_factory=dict)


OXE_DATASET_CONFIGS: Dict[str, OXEDatasetConfig] = {}


def register_oxe_dataset(name: str, config: OXEDatasetConfig,
                         transform: Optional[Callable] = None) -> None:
    OXE_DATASET_CONFIGS[name] = config
    if transform is not None:
        STANDARDIZATION_TRANSFORMS[name] = transform


def _D(
    primary: Optional[str] = None,
    secondary: Optional[str] = None,
    wrist: Optional[str] = None,
    state: Sequence[Optional[str]] = (),
    enc: int = StateEncoding.POS_EULER,
    act: int = ActionEncoding.EEF_POS,
    d_primary: Optional[str] = None,
    d_secondary: Optional[str] = None,
    d_wrist: Optional[str] = None,
    aux: Optional[Dict] = None,
) -> OXEDatasetConfig:
    return OXEDatasetConfig(
        image_obs_keys={"primary": primary, "secondary": secondary, "wrist": wrist},
        state_obs_keys=list(state),
        state_encoding=enc,
        action_encoding=act,
        depth_obs_keys={"primary": d_primary, "secondary": d_secondary, "wrist": d_wrist},
        aux_kwargs=dict(aux or {}),
    )


# --- full config table (configs.py:54-673; keys/encodings are dataset facts) --------

_PE, _PQ, _JT, _NO = (
    StateEncoding.POS_EULER, StateEncoding.POS_QUAT, StateEncoding.JOINT, StateEncoding.NONE,
)
_NONE8 = [None] * 8
_EEF_GRIP = ["EEF_state", None, "gripper_state"]
_eef_grip = ["eef_state", None, "gripper_state"]


def _droid_aux():
    from .oxe_transforms import droid_zero_action_filter

    return {"dataset_frame_transform_kwargs": {"chunk_filter_fn": droid_zero_action_filter}}


_CONFIG_TABLE: Dict[str, OXEDatasetConfig] = {
    "fractal20220817_data": _D("image", state=["base_pose_tool_reached", "gripper_closed"], enc=_PQ),
    "kuka": _D("image", state=["clip_function_input/base_pose_tool_reached", "gripper_closed"], enc=_PQ),
    "bridge_oxe": _D("image", "image_1", state=_EEF_GRIP),
    "bridge_orig": _D("image_0", "image_1", state=_EEF_GRIP),
    "bridge_dataset": _D("image_0", "image_1", state=_EEF_GRIP),
    "taco_play": _D("rgb_static", wrist="rgb_gripper", state=["state_eef", None, "state_gripper"],
                    d_primary="depth_static", d_wrist="depth_gripper"),
    "jaco_play": _D("image", wrist="image_wrist", state=["state_eef", None, "state_gripper"]),
    "berkeley_cable_routing": _D("image", "top_image", "wrist45_image",
                                 state=["robot_state", None], enc=_JT),
    "roboturk": _D("front_rgb", state=_NONE8, enc=_NO),
    "nyu_door_opening_surprising_effectiveness": _D(wrist="image", state=_NONE8, enc=_NO),
    "viola": _D("agentview_rgb", wrist="eye_in_hand_rgb",
                state=["joint_states", "gripper_states"], enc=_JT),
    "berkeley_autolab_ur5": _D("image", wrist="hand_image", state=["state"], enc=_PQ,
                               d_primary="depth"),
    "toto": _D("image", state=["state", None], enc=_JT),
    "language_table": _D("rgb", state=["effector_translation"] + [None] * 6),
    "columbia_cairlab_pusht_real": _D("image", wrist="wrist_image",
                                      state=["robot_state"] + [None] * 6),
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds":
        _D("image", state=["ee_position", "ee_orientation", None], enc=_PQ,
           d_primary="depth_image"),
    "nyu_rot_dataset_converted_externally_to_rlds": _D("image", state=_eef_grip),
    "stanford_hydra_dataset_converted_externally_to_rlds":
        _D("image", wrist="wrist_image", state=_eef_grip),
    "austin_buds_dataset_converted_externally_to_rlds":
        _D("image", wrist="wrist_image", state=["state"], enc=_JT),
    "nyu_franka_play_dataset_converted_externally_to_rlds":
        _D("image", "image_additional_view", state=["eef_state", None, None],
           d_primary="depth", d_secondary="depth_additional_view"),
    "maniskill_dataset_converted_externally_to_rlds":
        _D("image", wrist="wrist_image", state=["tcp_pose", "gripper_state"], enc=_PQ,
           d_primary="depth", d_wrist="wrist_depth"),
    "furniture_bench_dataset_converted_externally_to_rlds":
        _D("image", wrist="wrist_image", state=["state"], enc=_PQ),
    "cmu_franka_exploration_dataset_converted_externally_to_rlds":
        _D("highres_image", state=_NONE8, enc=_NO),
    "ucsd_kitchen_dataset_converted_externally_to_rlds":
        _D("image", state=["joint_state", None], enc=_JT),
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": _D("image", state=_eef_grip),
    "austin_sailor_dataset_converted_externally_to_rlds":
        _D("image", wrist="wrist_image", state=["state"], enc=_PQ),
    "austin_sirius_dataset_converted_externally_to_rlds":
        _D("image", wrist="wrist_image", state=["state"], enc=_PQ),
    "bc_z": _D("image", state=["present/xyz", "present/axis_angle", None, "present/sensed_close"]),
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": _D("image", state=_eef_grip),
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": _D("image", state=_eef_grip),
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds":
        _D("image", "image2", "hand_image", state=["end_effector_pose", None, None]),
    "utokyo_xarm_bimanual_converted_externally_to_rlds": _D("image", state=["pose_r", None, None]),
    "robo_net": _D("image", "image1", state=_eef_grip),
    "berkeley_mvp_converted_externally_to_rlds":
        _D(wrist="hand_image", state=["pose", "gripper"], enc=_PQ, act=ActionEncoding.JOINT_POS),
    "berkeley_rpt_converted_externally_to_rlds":
        _D(wrist="hand_image", state=["joint_pos", "gripper"], enc=_JT, act=ActionEncoding.JOINT_POS),
    "kaist_nonprehensile_converted_externally_to_rlds": _D("image", state=["state", None], enc=_PQ),
    "stanford_mask_vit_converted_externally_to_rlds": _D("image", state=_eef_grip),
    "tokyo_u_lsmo_converted_externally_to_rlds": _D("image", state=_eef_grip),
    "dlr_sara_pour_converted_externally_to_rlds": _D("image", state=["state", None, None]),
    "dlr_sara_grid_clamp_converted_externally_to_rlds": _D("image", state=["state", None, None]),
    "dlr_edan_shared_control_converted_externally_to_rlds": _D("image", state=["state", None]),
    "asu_table_top_converted_externally_to_rlds": _D("image", state=_eef_grip),
    "stanford_robocook_converted_externally_to_rlds":
        _D("image_1", "image_2", state=_eef_grip, d_primary="depth_1", d_secondary="depth_2"),
    "imperialcollege_sawyer_wrist_cam":
        _D("image", wrist="wrist_image", state=[None] * 7 + ["state"], enc=_NO),
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds":
        _D("image", wrist="wrist_image", state=["joint_state", "gripper_state"], enc=_JT),
    "uiuc_d3field": _D("image_1", "image_2", state=_NONE8, enc=_NO,
                       d_primary="depth_1", d_secondary="depth_2"),
    "utaustin_mutex": _D("image", wrist="wrist_image", state=["state"], enc=_JT),
    "berkeley_fanuc_manipulation":
        _D("image", wrist="wrist_image", state=["joint_state", None, "gripper_state"], enc=_JT),
    "cmu_playing_with_food": _D("image", wrist="finger_vision_1", state=["state", None, None]),
    "cmu_play_fusion": _D("image", state=["state"], enc=_JT),
    "cmu_stretch": _D("image", state=_eef_grip),
    "berkeley_gnm_recon": _D(wrist="image", state=["state", None, None]),
    "berkeley_gnm_cory_hall": _D(wrist="image", state=["state", None, None]),
    "berkeley_gnm_sac_son": _D(wrist="image", state=["state", None, None]),
    "droid": _D("exterior_image_1_left", "exterior_image_2_left", "wrist_image_left",
                state=["proprio"], enc=_PQ, aux=_droid_aux()),
    "fmb_dataset": _D("image_side_1", "image_side_2", "image_wrist_1", state=["proprio"],
                      d_primary="image_side_1_depth", d_secondary="image_side_2_depth",
                      d_wrist="image_wrist_1_depth"),
    "dobbe": _D("wrist_image", state=["proprio"]),
    "roboset": _D("image_left", "image_right", "image_wrist", state=["proprio"], enc=_JT,
                  act=ActionEncoding.JOINT_POS),
    "rh20t": _D("image_front", "image_side_right", "image_wrist", state=["proprio"]),
    "droid_wipe": _D("exterior_image_2_left", wrist="wrist_image_left", state=["proprio"]),
}
for _task in ("carrot_in_bowl", "pour_corn_in_pot", "flip_pot_upright",
              "move_object_onto_plate", "knock_object_over", "cover_object_with_towel"):
    _CONFIG_TABLE[f"tdroid_{_task}"] = _D(
        "static_image", state=_EEF_GRIP, d_primary="static_depth_image"
    )
for _suite in ("libero_spatial", "libero_object", "libero_goal", "libero_10"):
    _CONFIG_TABLE[f"{_suite}_no_noops"] = _D("image", wrist="wrist_image", state=_EEF_GRIP)


def _register_all() -> None:
    from .oxe_transforms import OXE_TRANSFORMS

    for name, cfg in _CONFIG_TABLE.items():
        register_oxe_dataset(name, cfg, transform=OXE_TRANSFORMS.get(name))
    # transforms without dataset configs (ppgm family; the reference registers
    # them in transforms.py:849-851 but ships no config either)
    for name, fn in OXE_TRANSFORMS.items():
        STANDARDIZATION_TRANSFORMS.setdefault(name, fn)


_register_all()


# --- named mixtures (mixtures.py:11-209; weights are the reference's constants) -----

_RTX_CORE: List[Tuple[str, float]] = [
    ("fractal20220817_data", 0.54087122203),
    ("kuka", 0.8341046294),
    ("bridge_orig", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 2.0),
    ("berkeley_cable_routing", 3.0),
    ("roboturk", 1.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 1.0),
    ("toto", 1.0),
]

_MAGIC_SOUP_CORE: List[Tuple[str, float]] = [
    ("fractal20220817_data", 0.54087122203),
    ("kuka", 0.8341046294),
    ("bridge_orig", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 1.0),
    ("berkeley_cable_routing", 1.0),
    ("roboturk", 2.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 2.0),
    ("toto", 1.0),
    ("language_table", 0.1),
    ("stanford_hydra_dataset_converted_externally_to_rlds", 2.0),
    ("austin_buds_dataset_converted_externally_to_rlds", 1.0),
    ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
    ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
    ("ucsd_kitchen_dataset_converted_externally_to_rlds", 2.0),
    ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
    ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
    ("dlr_edan_shared_control_converted_externally_to_rlds", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
    ("utaustin_mutex", 1.0),
    ("berkeley_fanuc_manipulation", 2.0),
    ("cmu_stretch", 1.0),
]

_SOUP_PLUS_EXTRAS: List[Tuple[str, float]] = [
    ("bc_z", 0.2),
    ("fmb_dataset", 1.0),
    ("dobbe", 0.2),
]

OXE_NAMED_MIXTURES: Dict[str, List[Tuple[str, float]]] = {
    "bridge": [("bridge_orig", 1.0)],
    "bridge_rt_1": [("bridge_orig", 1.0), ("fractal20220817_data", 1.0)],
    "rtx": list(_RTX_CORE),
    # rtx_franka intentionally repeats several datasets with extra weight
    # (mixtures.py:43-75); duplicates are collapsed at materialization with a
    # warning, exactly like the reference (materialize.py:108-114).
    "rtx_franka": list(_RTX_CORE) + [
        ("taco_play", 1.0),
        ("berkeley_cable_routing", 1.0),
        ("viola", 1.0),
        ("toto", 1.0),
        ("stanford_hydra_dataset_converted_externally_to_rlds", 1.0),
        ("austin_buds_dataset_converted_externally_to_rlds", 3.0),
        ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
        ("maniskill_dataset_converted_externally_to_rlds", 0.1),
        ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
        ("cmu_franka_exploration_dataset_converted_externally_to_rlds", 5.0),
        ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
        ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
        ("berkeley_rpt_converted_externally_to_rlds", 1.0),
        ("kaist_nonprehensile_converted_externally_to_rlds", 3.0),
        ("stanford_robocook_converted_externally_to_rlds", 1.0),
        ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
        ("utaustin_mutex", 1.0),
        ("cmu_play_fusion", 1.0),
    ],
    "oxe_magic_soup": list(_MAGIC_SOUP_CORE),
    "oxe_magic_soup_plus": list(_MAGIC_SOUP_CORE) + _SOUP_PLUS_EXTRAS + [("droid", 0.06)],
    # soup++ with fractal raised to 1.0, language_table and droid removed
    # (mixtures.py:140-169)
    "oxe_magic_soup_plus_minus":
        [("fractal20220817_data", 1.0)]
        + [e for e in _MAGIC_SOUP_CORE[1:] if e[0] != "language_table"]
        + list(_SOUP_PLUS_EXTRAS),
    "droid_wipe": [("droid_wipe", 1.0)],
    # repo extras (not in the reference): all four LIBERO suites at once, and a
    # small smoke-test soup
    "libero_all": [(f"{s}_no_noops", 1.0)
                   for s in ("libero_spatial", "libero_object", "libero_goal", "libero_10")],
    "oxe_magic_soup_lite": [
        ("fractal20220817_data", 1.0),
        ("kuka", 0.8),
        ("bridge_orig", 1.0),
        ("taco_play", 2.0),
    ],
}
for _task in ("carrot_in_bowl", "pour_corn_in_pot", "flip_pot_upright",
              "move_object_onto_plate", "knock_object_over", "cover_object_with_towel"):
    OXE_NAMED_MIXTURES[f"tdroid_{_task}"] = [(f"tdroid_{_task}", 1.0)]
for _suite in ("libero_spatial", "libero_object", "libero_goal", "libero_10"):
    OXE_NAMED_MIXTURES[f"{_suite}_no_noops"] = [(f"{_suite}_no_noops", 1.0)]


# --- kwargs materialization (oxe/materialize.py behavior) ----------------------------

def make_oxe_dataset_kwargs(
    dataset_name: str,
    data_dir: Optional[str] = None,
    load_camera_views: Sequence[str] = ("primary",),
    load_depth: bool = False,
    load_proprio: bool = True,
    load_language: bool = True,
) -> Dict:
    """Per-dataset pipeline kwargs incl. the EEF_POS/EEF_R6 normalization
    contract (materialize.py:22-79)."""
    if dataset_name not in OXE_DATASET_CONFIGS:
        raise KeyError(
            f"unregistered OXE dataset '{dataset_name}'; "
            f"register it via register_oxe_dataset(). Known: {sorted(OXE_DATASET_CONFIGS)}"
        )
    cfg = OXE_DATASET_CONFIGS[dataset_name]
    if cfg.action_encoding == ActionEncoding.EEF_POS:
        absolute_action_mask = [False] * 6 + [True]
        action_normalization_mask = [True] * 6 + [False]
    elif cfg.action_encoding == ActionEncoding.EEF_R6:
        absolute_action_mask = [False] * 9 + [True]
        action_normalization_mask = [True] * 9 + [False]
    else:
        raise ValueError(
            f"cannot load '{dataset_name}': only EEF_POS / EEF_R6 actions supported "
            f"(got encoding {cfg.action_encoding})"
        )
    missing = set(load_camera_views) - set(cfg.image_obs_keys)
    if missing:
        raise ValueError(f"cannot load {dataset_name}: missing camera views {missing}")
    out = dict(
        name=dataset_name,
        data_dir=data_dir,
        image_obs_keys={k: v for k, v in cfg.image_obs_keys.items() if k in load_camera_views},
        absolute_action_mask=absolute_action_mask,
        action_normalization_mask=action_normalization_mask,
        standardize_fn=STANDARDIZATION_TRANSFORMS.get(dataset_name),
    )
    if load_depth:
        out["depth_obs_keys"] = {
            k: v for k, v in cfg.depth_obs_keys.items() if k in load_camera_views
        }
    if load_proprio:
        out["state_obs_keys"] = cfg.state_obs_keys
    if load_language:
        out["language_key"] = "language_instruction"
    out.update(cfg.aux_kwargs)
    return out


def make_interleaved_mixture_kwargs(mixture_name: str, **kwargs) -> List[Dict]:
    """Expand a named mixture into per-dataset kwargs + weights. Duplicate
    dataset names keep the first weight (warned), and datasets that fail the
    camera/encoding contract are skipped with a warning — both matching
    materialize.py:108-131."""
    if mixture_name not in OXE_NAMED_MIXTURES:
        raise KeyError(f"unknown mixture '{mixture_name}'; known: {sorted(OXE_NAMED_MIXTURES)}")
    out, seen = [], set()
    for name, weight in OXE_NAMED_MIXTURES[mixture_name]:
        if name in seen:
            logger.warning("skipping duplicate dataset in mixture '%s': %s", mixture_name, name)
            continue
        seen.add(name)
        try:
            entry = make_oxe_dataset_kwargs(name, **kwargs)
        except ValueError as e:
            logger.warning("skipping '%s': %s", name, e)
            continue
        entry["sample_weight"] = weight
        out.append(entry)
    return out


# The two transforms under their older names, as the JAX package exports them.
def rt1_style_transform(traj):
    """fractal20220817_data-style standardization (transforms.py:102-116)."""
    from .oxe_transforms import OXE_TRANSFORMS

    return OXE_TRANSFORMS["fractal20220817_data"](traj)


def taco_play_transform(traj):
    from .oxe_transforms import OXE_TRANSFORMS

    return OXE_TRANSFORMS["taco_play"](traj)
