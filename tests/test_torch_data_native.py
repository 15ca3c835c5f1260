"""The port's native (C++) file layer against the JAX package's: its own
build of native/rlds_reader.cpp under build/, the reader's examples, the
JPEG decodes, the NumPy standardization, and the frames, batches and
counters of the native layer from the same seed.

The port's library is built by `g++` into build/native/; nothing is written
under native/ (the JAX package's own tests may `make -C native` in another
worker at the same time, so this file never diffs that directory).
Tolerances: everything exact (the same C++ code and NumPy arithmetic on the
same bytes)."""

import io
import json
import os
import shutil

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from roboticattack_tpu.data import native_loader as jnl
from roboticattack_tpu.data import native_pipeline as jnp_
from roboticattack_tpu.data import rlds as jr
from roboticattack_tpu.utils.prompting import WordStubTokenizer as JaxStub
from roboticattack_torch.data import native_loader as tnl
from roboticattack_torch.data import native_pipeline as tnp_
from roboticattack_torch.data import rlds as tr
from roboticattack_torch.data import synthetic_shards as tss
from roboticattack_torch.utils.prompting import WordStubTokenizer

from test_torch_data_tfrecord import assert_tree_equal, isolated_stats_cache, write_both  # noqa: F401

T = 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stats():
    return {"action": {"mean": [0.0] * 7, "std": [1.0] * 7, "min": [-3.0] * 7, "max": [3.0] * 7,
                       "q01": [-2.0] * 7, "q99": [2.0] * 7, "mask": [True] * 6 + [False]}}


def test_library_built_under_build_not_native():
    path = tnl.build_if_needed()
    assert path == tnl.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.basename(path).startswith("librlds_reader-") and os.path.isfile(path)
    assert tnl.SOURCE == os.path.join(REPO, "native", "rlds_reader.cpp")
    cmd = tnl.build_command("/tmp/out.so")
    assert cmd[0] == "g++" and cmd[cmd.index("-o") + 1] == "/tmp/out.so"
    under_native = [a for a in cmd if a.startswith(os.path.join(REPO, "native"))]
    assert under_native == [tnl.SOURCE]  # the source is read, nothing there is written
    for flag in ("-O2", "-fPIC", "-std=c++17", "-shared", "-lpthread"):
        assert flag in cmd
    assert tnl.load_library() is tnl.load_library()


def test_build_line_uses_the_vendored_headers_and_pillows_libjpeg(tmp_path, monkeypatch):
    """Both C++ helpers compile against roboticattack_torch/native/include
    and link Pillow's bundled libjpeg by full path with an rpath: no system
    -ljpeg. The library's name follows the build line. The JPEG round-trip
    helper builds and runs; without Pillow's libjpeg the build raises."""
    from roboticattack_torch.eval import jpeg
    from roboticattack_torch.utils import libjpeg

    include = os.path.join(REPO, "roboticattack_torch", "native", "include")
    lib = libjpeg.pillow_libjpeg()
    assert os.path.basename(os.path.dirname(lib)) == "pillow.libs" and ".so.62" in os.path.basename(lib)
    assert os.path.isfile(os.path.join(include, "jpeglib.h"))
    for cmd in (tnl.build_command("/tmp/out.so"), jpeg.build_command("/tmp/out.so")):
        assert "-ljpeg" not in cmd
        assert cmd[cmd.index("-I") + 1] == include
        assert lib in cmd and f"-Wl,-rpath,{os.path.dirname(lib)}" in cmd
    assert tnl.library_path() != libjpeg.hashed_path("rlds_reader", tnl.SOURCE, ["g++", "-ljpeg"], tnl.BUILD_DIR)
    img = np.random.default_rng(0).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    out = jpeg.jpeg_roundtrip(img)
    assert out.shape == img.shape and out.dtype == np.uint8 and 0 < np.abs(out.astype(int) - img).mean() < 64
    assert os.path.dirname(jpeg.library_path()) == os.path.join(REPO, "build", "native")
    import PIL

    monkeypatch.setattr(PIL, "__file__", str(tmp_path / "PIL" / "__init__.py"))
    with pytest.raises(FileNotFoundError, match="libjpeg"):
        tnl.build_command("/tmp/out.so")


def test_an_edited_header_names_a_new_library(tmp_path, monkeypatch):
    """The library's hash covers the vendored headers: a build against an
    edited jpeglib.h is never served the library built against the old one."""
    from roboticattack_torch.utils import libjpeg

    inc = tmp_path / "include"
    shutil.copytree(libjpeg.INCLUDE_DIR, inc)
    monkeypatch.setattr(libjpeg, "INCLUDE_DIR", str(inc))
    cmd = ["g++", "-I", str(inc)]
    before = libjpeg.hashed_path("rlds_reader", tnl.SOURCE, cmd, tnl.BUILD_DIR)
    assert libjpeg.hashed_path("rlds_reader", tnl.SOURCE, cmd, tnl.BUILD_DIR) == before
    with open(inc / "jpeglib.h", "a") as f:
        f.write("/* edited */\n")
    assert libjpeg.hashed_path("rlds_reader", tnl.SOURCE, cmd, tnl.BUILD_DIR) != before


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {")
    monkeypatch.setattr(tnl, "SOURCE", str(bad))
    monkeypatch.setattr(tnl, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="g\\+\\+ exit") as e:
        tnl.build_if_needed()
    assert "broken.cpp" in str(e.value)
    assert os.listdir(tmp_path / "out") == []  # no partial library left behind


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shard") / "ep.tfrecord")
    tss.write_episode_tfrecord(path, n_episodes=3, steps=T, rng=np.random.default_rng(4),
                               image_key="image_0", image_size=40)
    return path


def test_reader_examples_equal(shard):
    keys = ("steps/action", "steps/observation/state")
    got = [(ex.feature_count("steps/observation/image_0"),
            [ex.feature(k) for k in keys],
            [ex.bytes_at("steps/observation/image_0", i) for i in range(T)],
            ex.feature("steps/language_instruction"))
           for ex in tnl.NativeRLDSReader([shard], prefetch_depth=2)]
    want = [(ex.feature_count("steps/observation/image_0"),
             [ex.feature(k) for k in keys],
             [ex.bytes_at("steps/observation/image_0", i) for i in range(T)],
             ex.feature("steps/language_instruction"))
            for ex in jnl.NativeRLDSReader([shard], prefetch_depth=2)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[0] == w[0] == T
        for a, b in zip(g[1], w[1]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert g[2] == w[2] and g[3] == w[3]
    with pytest.raises(KeyError):
        next(iter(tnl.NativeRLDSReader([shard]))).feature("no/such/key")


@pytest.mark.parametrize("size", [None, 32, 56, 224])
def test_jpeg_decodes_equal(size):
    from PIL import Image

    rng = np.random.default_rng(size or 0)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (64, 80, 3), dtype=np.uint8)).save(buf, format="JPEG")
    data = buf.getvalue()
    if size is None:
        got, want = tnl.decode_jpeg(data), jnl.decode_jpeg(data)
    else:
        got, want = tnl.decode_jpeg_resized(data, size), jnl.decode_jpeg_resized(data, size)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for mod in (tnl, jnl):
        with pytest.raises(ValueError):
            mod.decode_jpeg(b"\xff\xd8\xff\xe0 not a jpeg")


def test_numpy_standardization_equal():
    rng = np.random.default_rng(2)
    grip = rng.choice([0.0, 0.02, 0.5, 0.97, 1.0], 40).astype(np.float32)
    np.testing.assert_array_equal(tnp_.np_binarize_gripper_actions(grip),
                                  jnp_.np_binarize_gripper_actions(grip))

    def traj():
        r = np.random.default_rng(3)
        return {"image": np.arange(T), "action": r.standard_normal((T, 7)).astype(np.float32),
                "language": np.array([b"x"] * T, object),
                "observation": {"state": r.standard_normal((T, 7)).astype(np.float32)}}

    for name in ("bridge_orig", "libero_goal_no_noops"):
        assert_tree_equal(tnp_.NP_STANDARDIZATION_TRANSFORMS[name](traj()),
                          jnp_.NP_STANDARDIZATION_TRANSFORMS[name](traj()))
    assert sorted(tnp_.NP_STANDARDIZATION_TRANSFORMS) == sorted(jnp_.NP_STANDARDIZATION_TRANSFORMS)
    act = rng.standard_normal((T, 7)).astype(np.float32) * 3
    np.testing.assert_array_equal(tnp_.np_normalize_actions(act, _stats()),
                                  jnp_.np_normalize_actions(act, _stats()))


def test_discover_tfrecords_equal(tmp_path):
    jdir, tdir = write_both(tmp_path, n_episodes=4, n_shards=2)
    got = tnp_.discover_tfrecords("bridge_orig", tdir)
    want = jnp_.discover_tfrecords("bridge_orig", jdir)
    assert [os.path.relpath(p, tdir) for p in got] == [os.path.relpath(p, jdir) for p in want]
    for mod in (tnp_, jnp_):
        with pytest.raises(FileNotFoundError):
            mod.discover_tfrecords("libero_10_no_noops", tdir)


@pytest.mark.parametrize("train,shuffle", [(True, 16), (True, 1), (False, 16)])
def test_first_64_frames_equal(tmp_path, train, shuffle):
    """make_frame_dataset(file_layer='native'): the same first 64 frames
    (the reservoir shuffle from the same seed, epochs cycled; the val split
    reads every train shard, as the JAX package's does)."""
    jdir, tdir = write_both(tmp_path, n_episodes=6, n_shards=2, image_size=40)
    kw = dict(train=train, stats=_stats(), image_size=56, seed=5, shuffle_buffer=shuffle,
              file_layer="native")
    wframes, wstats = jr.make_frame_dataset("bridge_orig", jdir, **kw)
    gframes, gstats = tr.make_frame_dataset("bridge_orig", tdir, **kw)
    assert gstats is kw["stats"] and wstats is kw["stats"]
    n = 64 if train else 6 * (T - 2)  # val: one pass over the episodes
    git, wit = gframes.as_numpy_iterator(), wframes.as_numpy_iterator()
    for g, w in zip([next(git) for _ in range(n)], [next(wit) for _ in range(n)]):
        assert_tree_equal(g, w)


def test_native_needs_stats_as_jax(tmp_path):
    jdir, tdir = write_both(tmp_path, n_episodes=2)
    for mod, d in ((jr, jdir), (tr, tdir)):
        with pytest.raises(ValueError, match="needs `stats`"):
            mod.make_frame_dataset("bridge_orig", data_dir=d, file_layer="native")


def test_native_attack_batches_and_counters_equal(tmp_path):
    jdir, tdir = write_both(tmp_path, n_episodes=5, image_size=40,
                            language=b"move the red block to the top left corner of the table")
    out = {}
    for pkg, mod, tok, d in (("jax", jr, JaxStub(), jdir), ("torch", tr, WordStubTokenizer(), tdir)):
        counters = {}
        train, val = mod.make_attack_iterators(
            "bridge_orig", 4, seed=9, data_dir=d, tokenizer=tok, pad_to=48, counters=counters,
            file_layer="native", stats=_stats(), shuffle_buffer=8, image_size=56)
        out[pkg] = ([next(train) for _ in range(3)] + [next(val)], counters)
    (got, gc), (want, wc) = out["torch"], out["jax"]
    assert gc == wc == {"frames_seen": 12, "frames_skipped_pad_to": 0}
    for g, w in zip(got, want):
        for name, a, b in zip(g._fields, g, w):
            assert a.dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_skip_rate_counters_equal():
    class LongPromptFrames:
        def as_numpy_iterator(self):
            rng = np.random.default_rng(0)
            i = 0
            while True:
                yield {"image": rng.integers(0, 255, (56, 56, 3), dtype=np.uint8),
                       "action": rng.uniform(-1, 1, 7).astype(np.float32),
                       "language": ("word " * (40 if i % 2 else 2)).encode()}
                i += 1

    counters = {}
    for mod, tok in ((jr, JaxStub()), (tr, WordStubTokenizer())):
        c = {}
        it = mod.frames_to_attack_batches(LongPromptFrames(), tok, batch_size=4, pad_to=32, counters=c)
        batches = [next(it) for _ in range(2)]
        counters[mod] = (c, batches)
    (gc, gb), (wc, wb) = counters[tr], counters[jr]
    assert gc == wc and gc["frames_skipped_pad_to"] == 7 and gc["frames_seen"] == 15
    for g, w in zip(gb, wb):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_stats_json_blob_for_the_native_cli(tmp_path):
    """What --stats_json feeds the native layer round-trips through
    save_reference_statistics unchanged, in the schema of the JAX writer."""
    blob = {"bridge_orig": _stats()}
    tr.save_reference_statistics(blob, str(tmp_path / "t.json"))
    jr.save_reference_statistics(blob, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert json.loads((tmp_path / "t.json").read_text()) == blob


@pytest.mark.parametrize("layer", ["native"])
def test_chip_smoke_data_phase_on_the_cpu(layer, monkeypatch):
    """chip_smoke.phase_data rehearsed on the CPU at a tiny size (vla-tiny
    with flash attention and remat; 4 episodes of 6 steps, 64x64 frames):
    every check of the phase on the native reader (bit-equal batches,
    statistics in the run dir, B1/B2 launches counted on their plain
    versions, DATA_* lines, the patch moved, the batch's way onto the
    device). The torch.cuda calls are stubbed: the CPU has no card."""
    import dataclasses

    import chip_smoke
    import torch
    from roboticattack_torch.models.config import REGISTRY, VLA_TINY
    from roboticattack_torch.ops import flash_attention as fa

    tiny = dataclasses.replace(VLA_TINY, name="vla-tiny-flash-remat", remat=True,
                               llm=dataclasses.replace(VLA_TINY.llm, attn_impl="flash"))
    monkeypatch.setitem(REGISTRY, tiny.name, tiny)
    for name, value in (("MODEL", tiny.name), ("DEVICE", "cpu"), ("DATA_LAYER", layer), ("DATA_EPISODES", 4),
                        ("DATA_STEPS", 6), ("DATA_FRAME", 64)):
        monkeypatch.setattr(chip_smoke, name, value)
    for kind in ("fwd", "bwd"):  # the plain versions launch nothing: count their calls
        plain = getattr(fa, f"flash_attention_{kind}_plain")

        def counted(*a, _plain=plain, _kind=kind, **k):
            fa.flash_attention.launches[_kind] += 1
            return _plain(*a, **k)

        monkeypatch.setattr(fa, f"flash_attention_{kind}_plain", counted)
    for name, value in (("synchronize", None), ("mem_get_info", (1 << 30, 1 << 30)), ("memory_reserved", 0),
                        ("reset_peak_memory_stats", None), ("max_memory_allocated", 0), ("empty_cache", None)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value, **k: _v)
    layers = tiny.llm.num_layers
    want = {"fwd": 3 * 2 * 2 * layers + 2 * layers, "bwd": 3 * 2 * layers}
    att = {"want": want, "cli_peak_gib": 0.0,
           "cli_timing": {"TIMING_p50_s": 1.0, "TIMING_min_s": 1.0, "TIMING_mean_s": 1.0}}
    out = chip_smoke.phase_data("CPU", att)
    assert out["bytes"] > 0 and set(out["h2d_ms"]) == {"pinned", "pageable"}
    assert out["launches"] == want and out["frames_per_s"] > 0 and out["first_batch_s"] > 0
    assert set(out["timing"]) >= {"TIMING_p50_s", "TIMING_min_s"}
    assert not os.path.exists(os.path.join(REPO, "build", "chip_smoke_rlds"))
