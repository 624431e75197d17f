"""The port's data preparation tool (``python -m vidsitu_tpu_torch.prep``),
a copy of the JAX package's ``prep.py`` with one repair: the download's
clip check takes a malformed container as invalid. Every case of the JAX
package's prep tests (tests/test_misc_modules.py, test_frame_cache.py) runs
here against the port's module, with the subprocess calls faked (no
yt-dlp, ffmpeg or network).

``count_frames`` parses ffprobe's JSON: a container without a video
stream raises ``IndexError``, one without a packet count ``KeyError``, a
count that is no integer ``ValueError``. The JAX package's ``_valid``
catches only ``subprocess.SubprocessError``, so any of the three escapes
``download_clip`` (``IndexError`` only from the check of a clip already on
disk: the retry loop catches it) and ends that worker's remaining
downloads; the port's retries the clip and returns ``None``.
``test_malformed_clip_fault_is_pinned`` holds both behaviours on the same
faked input.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import vidsitu_tpu.prep as jax_prep
import vidsitu_tpu_torch.prep as prep

SEG = "v_abc_seg_10_20"
MALFORMED = {
    IndexError: {"streams": []},  # no video stream
    KeyError: {"streams": [{}]},  # no packet count
    ValueError: {"streams": [{"nb_read_packets": "N/A"}]},
}


def test_prep_parse_and_pool():
    ytid, st, en = prep.parse_seg_name("v_abc-123_xy_seg_25_35")
    assert ytid == "abc-123_xy" and st == 25.0 and en == 35.0

    res = prep.run_pool(lambda x: x * 2, [1, 2, 3], max_workers=2)
    assert res == {1: 2, 2: 4, 3: 6}
    # exceptions are captured per item, not raised
    res2 = prep.run_pool(lambda x: 1 // x, [0, 1], max_workers=2)
    assert isinstance(res2[0], ZeroDivisionError) and res2[1] == 1

    if shutil.which("ffmpeg") is None:
        with pytest.raises(prep.MissingToolError, match="ffmpeg"):
            prep.extract_frames("x.mp4", "/tmp/fr", "v_a_seg_0_10")


def test_download_clip_idempotent_rerun(tmp_path, monkeypatch):
    """An already downloaded, size- and frame-valid clip is kept: no
    subprocess runs on a rerun."""
    out = tmp_path / f"{SEG}.mp4"
    out.write_bytes(b"x" * 30_000)
    monkeypatch.setattr(prep.shutil, "which", lambda b: f"/bin/{b}")
    monkeypatch.setattr(prep, "count_frames", lambda p: 300)

    def no_run(*a, **k):
        raise AssertionError("no subprocess should run on a valid rerun")

    monkeypatch.setattr(prep.subprocess, "run", no_run)
    assert prep.download_clip(SEG, tmp_path) == out


def test_download_clip_failure_leaves_no_partial(tmp_path, monkeypatch):
    """A download that stays undersized returns None and removes the bad
    mp4; the backoff applies to the size failure too."""
    out = tmp_path / f"{SEG}.mp4"
    monkeypatch.setattr(prep.shutil, "which", lambda b: f"/bin/{b}")
    sleeps = []
    monkeypatch.setattr(prep.time, "sleep", sleeps.append)

    class _R:
        stdout = "http://u\n"

    def fake_run(cmd, **k):
        if cmd[0] == "ffmpeg":
            out.write_bytes(b"tiny")  # a truncated stream
        return _R()

    monkeypatch.setattr(prep.subprocess, "run", fake_run)
    assert prep.download_clip(SEG, tmp_path, retries=2) is None
    assert not out.exists()
    assert len(sleeps) == 2


def _fake_tools(mod, monkeypatch, out, probe_json, calls):
    """yt-dlp, ffmpeg and ffprobe on PATH; ffmpeg writes a 30 kB mp4 and
    ffprobe prints ``probe_json``. Records each command's program."""
    monkeypatch.setattr(mod.shutil, "which", lambda b: f"/bin/{b}")
    monkeypatch.setattr(mod.time, "sleep", lambda s: None)

    class _R:
        def __init__(self, stdout):
            self.stdout = stdout

    def fake_run(cmd, **k):
        calls.append(cmd[0])
        if cmd[0] == "ffmpeg":
            out.write_bytes(b"x" * 30_000)
        if cmd[0] == "ffprobe":
            return _R(json.dumps(probe_json))
        return _R("http://u\n")

    monkeypatch.setattr(mod.subprocess, "run", fake_run)


@pytest.mark.parametrize("exc", list(MALFORMED), ids=lambda e: e.__name__)
def test_malformed_clip_is_retried_then_reported(tmp_path, monkeypatch,
                                                 exc):
    """ffprobe's output makes ``count_frames`` raise ``exc``: the port's
    ``download_clip`` takes the clip as invalid, retries it, removes it
    and returns None."""
    out = tmp_path / f"{SEG}.mp4"
    calls = []
    _fake_tools(prep, monkeypatch, out, MALFORMED[exc], calls)
    with pytest.raises(exc):
        prep.count_frames(out)
    calls.clear()
    assert prep.download_clip(SEG, tmp_path, retries=2) is None
    assert not out.exists()
    assert calls.count("yt-dlp") == calls.count("ffmpeg") == 2, calls


@pytest.mark.parametrize("exc", list(MALFORMED), ids=lambda e: e.__name__)
def test_malformed_clip_does_not_stop_the_other_downloads(tmp_path,
                                                          monkeypatch, exc):
    """``main --task_type=dwn_vids`` with one malformed segment among
    good ones, one worker: the malformed one fails (both passes, the
    second with webm) and every other segment is still downloaded."""
    segs = ["v_a_seg_0_10", "v_bad_seg_0_10", "v_c_seg_0_10"]
    monkeypatch.setattr(prep.shutil, "which", lambda b: f"/bin/{b}")
    monkeypatch.setattr(prep.time, "sleep", lambda s: None)
    current, fetched = {}, []

    class _R:
        def __init__(self, stdout):
            self.stdout = stdout

    def fake_run(cmd, **k):
        if cmd[0] == "yt-dlp":
            current["seg"] = "v_" + cmd[-1].split("v=")[1] + "_seg_0_10"
        elif cmd[0] == "ffmpeg":
            Path(cmd[-1]).write_bytes(b"x" * 30_000)
            fetched.append(current["seg"])
        elif cmd[0] == "ffprobe":
            bad = current["seg"] == "v_bad_seg_0_10"
            return _R(json.dumps(MALFORMED[exc] if bad else {
                "streams": [{"nb_read_packets": "300"}]}))
        return _R("http://u\n")

    monkeypatch.setattr(prep.subprocess, "run", fake_run)
    split = tmp_path / "segs.json"
    split.write_text(json.dumps(segs))
    prep.main(["--task_type=dwn_vids", f"--split_file={split}",
               f"--video_dir={tmp_path / 'vids'}", "--max_workers=1",
               "--retry_count=1", "--setup_cfg="])
    assert sorted((tmp_path / "vids").glob("*.mp4")) == [
        tmp_path / "vids" / f"{s}.mp4" for s in ("v_a_seg_0_10",
                                                 "v_c_seg_0_10")]
    assert fetched.count("v_bad_seg_0_10") == 2  # 22/best, then webm


@pytest.mark.parametrize("rerun", [False, True], ids=["fresh", "rerun"])
@pytest.mark.parametrize("exc", list(MALFORMED), ids=lambda e: e.__name__)
def test_malformed_clip_fault_is_pinned(tmp_path, monkeypatch, exc, rerun):
    """The same faked input through both packages. The JAX package's
    ``download_clip`` lets ``exc`` escape: from its first attempt for
    ``KeyError`` and ``ValueError`` (its retry loop catches ``IndexError``
    only), and for all three from the check of a clip already on disk
    (a rerun). The port's retries and returns None in every case."""
    out = tmp_path / f"{SEG}.mp4"
    calls = []
    _fake_tools(jax_prep, monkeypatch, out, MALFORMED[exc], calls)
    if rerun:
        out.write_bytes(b"x" * 30_000)
    if rerun or exc is not IndexError:
        with pytest.raises(exc):
            jax_prep.download_clip(SEG, tmp_path, retries=2)
        assert calls.count("ffmpeg") == (0 if rerun else 1)
    else:
        assert jax_prep.download_clip(SEG, tmp_path, retries=2) is None
    calls.clear()
    _fake_tools(prep, monkeypatch, out, MALFORMED[exc], calls)
    if rerun:
        out.write_bytes(b"x" * 30_000)
    assert prep.download_clip(SEG, tmp_path, retries=2) is None
    assert calls.count("ffmpeg") == 2 and not out.exists()


def test_prep_dwn_vids_webm_fallback(tmp_path, monkeypatch, capsys):
    """Failed downloads get a second pass with format webm."""
    calls = []

    def fake_download(seg, out_dir, fmt="22/best", retries=3, **kw):
        calls.append((seg, fmt))
        if seg == "v_bad_seg_0_10" and fmt != "webm":
            return None
        return Path(f"/fake/{seg}.mp4")

    monkeypatch.setattr(prep, "download_clip", fake_download)
    split = tmp_path / "segs.json"
    split.write_text(json.dumps(["v_ok_seg_0_10", "v_bad_seg_0_10"]))
    prep.main([
        "--task_type=dwn_vids", f"--split_file={split}",
        f"--video_dir={tmp_path}", "--max_workers=1",
    ])
    assert ("v_bad_seg_0_10", "webm") in calls
    assert ("v_ok_seg_0_10", "webm") not in calls
    assert "downloaded 2/2" in capsys.readouterr().out


def test_prep_setup_yaml_surface(tmp_path, monkeypatch, capsys):
    """Defaults come from a setup YAML with the reference's key names, the
    split list is the union of split_dir's JSON files, and explicit flags
    override the YAML; the packaged default YAML parses."""
    split_dir = tmp_path / "split_files"
    split_dir.mkdir()
    (split_dir / "a_split.json").write_text(
        json.dumps(["v_a_seg_0_10", "v_b_seg_0_10"]))
    (split_dir / "b_split.json").write_text(
        json.dumps(["v_b_seg_0_10", "v_c_seg_0_10"]))
    setup = tmp_path / "setup.yml"
    setup.write_text(
        f"video_trimmed_dir: '{tmp_path / 'vids'}'\n"
        f"split_dir: '{split_dir}'\n"
        "max_processes: 1\n"
        "retry_count: 7\n")
    seen = []

    def fake_download(seg, out_dir, fmt="22/best", retries=3, **kw):
        seen.append((seg, str(out_dir), retries))
        return Path(f"/fake/{seg}.mp4")

    monkeypatch.setattr(prep, "download_clip", fake_download)
    prep.main(["--task_type=dwn_vids", f"--setup_cfg={setup}"])
    assert sorted(s for s, _, _ in seen) == [
        "v_a_seg_0_10", "v_b_seg_0_10", "v_c_seg_0_10"]
    assert all(d == str(tmp_path / "vids") for _, d, _ in seen)
    assert all(r == 7 for _, _, r in seen)
    assert "downloaded 3/3" in capsys.readouterr().out

    seen.clear()
    prep.main(["--task_type=dwn_vids", f"--setup_cfg={setup}",
               f"--video_dir={tmp_path / 'other'}"])
    assert all(d == str(tmp_path / "other") for _, d, _ in seen)

    assert prep._SETUP_CFG.exists()
    assert prep._SETUP_CFG.parent.parent == Path(prep.__file__).parent
    mapped = prep._load_setup_cfg(prep._SETUP_CFG)
    assert mapped["max_workers"] == 30
    assert mapped["video_dir"] == "./data/vsitu_video_trimmed_dir"


def test_prep_cli_builds_cache(tmp_path):
    """``--task_type=build_frame_cache`` writes the port's uint8 frame
    cache, one (300, hw, hw, 3) array a segment."""
    from vidsitu_tpu_torch.data.synth import make_synth_dataset

    paths = make_synth_dataset(tmp_path / "d", n_train=2, n_valid=1,
                               n_test=1, with_frames=True, frame_hw=32)
    frames_dir = paths["ds.vsitu.video_frms_tdir"]
    segs = sorted(p.name for p in Path(frames_dir).iterdir())
    split_file = tmp_path / "segs.json"
    split_file.write_text(json.dumps(segs[:2]))
    cache_dir = tmp_path / "cli_cache"
    prep.main([
        "--task_type=build_frame_cache", f"--split_file={split_file}",
        f"--frames_dir={frames_dir}", f"--cache_dir={cache_dir}",
        "--out_hw=32", "--max_workers=2",
    ])
    built = sorted(p.name for p in cache_dir.glob("*_32.npy"))
    assert built == [f"{s}_32.npy" for s in segs[:2]]
    arr = np.load(cache_dir / built[0], mmap_mode="r")
    assert arr.shape == (300, 32, 32, 3) and arr.dtype == np.uint8
