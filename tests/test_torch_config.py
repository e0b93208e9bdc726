"""The port's rc configuration (``pysteps_tpu_torch/config.py``) against the
JAX package's: the same rc file loads to the same dict, a bad file raises
as JAX's loader does, ``dryrun`` leaves ``rcparams`` alone, the search
order and names are the same, and the packaged defaults are the port's own
copies (equal in content to the JAX package's)."""

import json
from pathlib import Path

import pytest

from pysteps_tpu import config as jconfig
from pysteps_tpu_torch import config as tconfig

ROOT = Path(__file__).resolve().parents[1]

GOOD_RC = """// a user's rc file
{
    "outputs": {"path_workdir": "/tmp/skill // not a comment"},
    "silent_import": true,
    "plot": {"motion_plot": "streamplot", "colorscale": "STEPS-BE"},  // trailing
    "data_sources": {
        "mine": {"root_path": "/data", "path_fmt": "%Y", "fn_pattern": "x_%H%M",
                 "fn_ext": "npz", "importer": "npz", "timestep": 10,
                 "importer_kwargs": {"a": 1}}
    }
}
"""

BAD_RCS = {
    "missing_plot": '{"outputs": {"path_workdir": "."}, "data_sources": {}}',
    "wrong_type": '{"outputs": {"path_workdir": 3}, "plot": {"motion_plot": "q", '
                  '"colorscale": "p"}, "data_sources": {}}',
    "bad_source": '{"outputs": {"path_workdir": "."}, "plot": {"motion_plot": "q", '
                  '"colorscale": "p"}, "data_sources": {"s": {"root_path": "."}}}',
    "bool_as_int": '{"outputs": {"path_workdir": "."}, "plot": {"motion_plot": "q", '
                   '"colorscale": "p"}, "data_sources": {"s": {"root_path": ".", '
                   '"path_fmt": "", "fn_pattern": "", "fn_ext": "", "importer": "", '
                   '"timestep": true, "importer_kwargs": {}}}}',
    "not_json": '{"outputs": ',
}


def _isolate(monkeypatch, tmp_path):
    """No user rc file anywhere on the search path."""
    monkeypatch.delenv("PYSTEPS_TPU_RC", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)


def test_packaged_rc_files_are_the_ports_own_copies(monkeypatch, tmp_path):
    _isolate(monkeypatch, tmp_path)
    port_dir = ROOT / "pysteps_tpu_torch"
    assert Path(tconfig.config_fname()) == port_dir / "pysteps_tpu_rc"
    assert Path(jconfig.config_fname()) == ROOT / "pysteps_tpu" / "pysteps_tpu_rc"
    for name in ("pysteps_tpu_rc", "pysteps_tpu_rc_schema.json"):
        assert (port_dir / name).read_text() == (ROOT / "pysteps_tpu" / name).read_text()
    assert tconfig._rc_schema() == jconfig._rc_schema()


@pytest.mark.parametrize("source", ["packaged", "user"])
def test_same_rc_file_loads_to_the_same_dict(source, tmp_path):
    if source == "packaged":
        path = str(ROOT / "pysteps_tpu_torch" / "pysteps_tpu_rc")
    else:
        path = str(tmp_path / "pysteps_tpu_rc")
        Path(path).write_text(GOOD_RC)
    out = tconfig.load_config_file(path, dryrun=True)
    ref = jconfig.load_config_file(path, dryrun=True)
    assert json.dumps(out, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert isinstance(out, tconfig.DotDict)
    if source == "user":
        assert out.outputs.path_workdir == "/tmp/skill // not a comment"
        assert out.data_sources.mine.timestep == 10


@pytest.mark.parametrize("case", list(BAD_RCS))
def test_a_bad_rc_file_raises_as_jax_does(case, tmp_path):
    path = tmp_path / "bad_rc"
    path.write_text(BAD_RCS[case])
    with pytest.raises(Exception) as ref:
        jconfig.load_config_file(str(path), dryrun=True)
    with pytest.raises(type(ref.value)) as out:
        tconfig.load_config_file(str(path), dryrun=True)
    assert str(out.value) == str(ref.value)


def test_dryrun_leaves_rcparams_and_a_load_replaces_them(monkeypatch, tmp_path):
    path = tmp_path / "pysteps_tpu_rc"
    path.write_text(GOOD_RC)
    monkeypatch.setattr(tconfig, "rcparams", tconfig.rcparams)
    before = json.dumps(tconfig.rcparams, sort_keys=True)
    tconfig.load_config_file(str(path), dryrun=True)
    assert json.dumps(tconfig.rcparams, sort_keys=True) == before
    loaded = tconfig.load_config_file(str(path), verbose=True)
    assert tconfig.rcparams is loaded and loaded.plot.colorscale == "STEPS-BE"


def test_search_order_and_names(monkeypatch, tmp_path):
    _isolate(monkeypatch, tmp_path)
    home_rc = tmp_path / "home" / ".pysteps_tpu" / "pysteps_tpu_rc"
    home_rc.parent.mkdir(parents=True)
    home_rc.write_text(GOOD_RC)
    assert tconfig.config_fname() == jconfig.config_fname() == str(home_rc)
    (tmp_path / "pystepsrc").write_text(GOOD_RC)
    assert tconfig.config_fname() == jconfig.config_fname() == str(tmp_path / "pystepsrc")
    (tmp_path / "pysteps_tpu_rc").write_text(GOOD_RC)
    assert tconfig.config_fname() == jconfig.config_fname() == str(tmp_path / "pysteps_tpu_rc")
    env_dir = tmp_path / "env"
    env_dir.mkdir()
    (env_dir / "pysteps_tpu_rc").write_text(GOOD_RC)
    monkeypatch.setenv("PYSTEPS_TPU_RC", str(env_dir))
    assert tconfig.config_fname() == jconfig.config_fname() == str(env_dir / "pysteps_tpu_rc")
    assert list(tconfig._candidate_paths()) == list(jconfig._candidate_paths())


def test_unreadable_file_warns_and_keeps_the_defaults(tmp_path):
    missing = tmp_path / "does_not_exist"
    missing.mkdir()
    with pytest.warns(UserWarning):
        out = tconfig.load_config_file(str(missing), dryrun=True)
    assert out == tconfig._DEFAULT_RC


@pytest.mark.parametrize("line", [
    '"a": "http://x//y", // c', '// whole line', '"b": "\\"q\\" // x" // y', "no comment",
])
def test_comment_strip_like_jax(line):
    assert tconfig._strip_json_comments(line) == jconfig._strip_json_comments(line)


def test_dotdict_attribute_access():
    d = tconfig.DotDict({"a": {"b": 1}})
    assert d.a.b == 1
    d.c = 2
    assert d["c"] == 2
    with pytest.raises(AttributeError):
        d.missing
