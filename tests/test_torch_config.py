"""The port's config layer (``music2midi_tpu_torch/config.py`` over
``yaml_subset.py``) against the JAX package's (``music2midi_tpu/config.py``
over PyYAML).

Bars: for every YAML config of the repository (``config.yaml``,
``configs/*.yaml``) and a JSON export of each, ``load_config`` gives the
JAX tree with the same Python type at every leaf; ``save_config`` writes
JAX's bytes; a hypothesis property holds the round trip both ways on
nested trees of every scalar kind ``safe_dump`` writes; texts in the
subset (comments, flow sequences, PyYAML 1.1's ``1e-3`` and ``yes``)
read as ``yaml.safe_load`` reads them; each construct outside the subset
raises ValueError naming the file and the line; ``default_config()``
equals JAX's.
"""

import json
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import music2midi_tpu.config as jax_config
from music2midi_tpu_torch import config as port_config
from music2midi_tpu_torch import yaml_subset

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = [ROOT / "config.yaml", *sorted((ROOT / "configs").glob("*.yaml"))]


def same(a, b) -> bool:
    """Equal values with the same type at every leaf (floats by repr, so
    nan equals nan and -0.0 differs from 0.0)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, float):
        return repr(a) == repr(b)
    return a == b


def test_the_repository_has_its_configs():
    names = {p.name for p in CONFIGS}
    assert {"config.yaml", "synth16k.yaml", "synth16k_aug.yaml",
            "synth16k_aug_r5.yaml"} <= names


@pytest.mark.parametrize("form", ["yaml", "json"])
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_equals_jax(path, form, tmp_path):
    if form == "json":
        tree = jax_config.load_config(path).to_dict()
        path = tmp_path / "config.json"
        path.write_text(json.dumps(tree, indent=2))
    got = port_config.load_config(path).to_dict()
    want = jax_config.load_config(path).to_dict()
    assert same(got, want), (got, want)


def test_the_r5_recipe_keeps_its_types():
    cfg = port_config.load_config(ROOT / "configs" / "synth16k_aug_r5.yaml")
    assert type(cfg.dataset.sample_rate) is int
    assert cfg.dataset.sample_rate == 16000
    assert type(cfg.dataset.augment) is bool and cfg.dataset.augment
    assert type(cfg.dataset.cache_augment_mb) is int
    assert type(cfg.spectrogram.f_min) is float
    assert type(cfg.dataset.filter_threshold.max_beat_fluctuation) is float
    assert cfg.model.t5.feed_forward_proj == "gated-gelu"
    assert cfg.model.t5.tie_word_embeddings is False
    assert list(cfg.conditioning.difficulty) == [
        "beginner", "intermediate", "advanced"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_save_config_bytes_equal_jax(path, tmp_path):
    port_config.save_config(port_config.load_config(path), tmp_path / "p")
    jax_config.save_config(jax_config.load_config(path), tmp_path / "j")
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    # and the port reads its own output back to the same tree
    assert same(port_config.load_config(tmp_path / "p").to_dict(),
                jax_config.load_config(path).to_dict())


def test_default_config_equals_jax():
    assert port_config.default_config_path() == \
        jax_config.default_config_path()
    assert same(port_config.default_config().to_dict(),
                jax_config.default_config().to_dict())
    assert same(port_config.resolve_config(None).to_dict(),
                jax_config.resolve_config(None).to_dict())
    path = str(ROOT / "configs" / "synth16k.yaml")
    assert same(port_config.resolve_config(path).to_dict(),
                jax_config.resolve_config(path).to_dict())


_text = st.text(alphabet=st.characters(blacklist_categories=("Cs",)),
                max_size=100)
_keys = st.one_of(
    st.sampled_from(["dataset", "sample_rate", "yes", "1", "null", "1e-3",
                     "a: b", "k k", "-k", "#k", "[k]", "~"]),
    st.text(alphabet=st.characters(blacklist_categories=("Cs",),
                                   blacklist_characters="\n\r\x85\u2028\u2029"),
            min_size=1, max_size=20))
_scalars = st.one_of(
    st.integers(), st.floats(), st.booleans(), st.none(),
    st.sampled_from(["1", "1.0", "1e-3", "1.0e+3", "yes", "No", "on", "OFF",
                     "null", "~", "", " ", ".inf", "-.5", ".nan", "0x1f",
                     "017", "1:30", "2024-01-01", "true", "a: b", "# c",
                     "- x", "[1]", "{}", "'q'", '"q"', "x #y", "<<", "="]),
    _text)
_leaves = st.one_of(_scalars, st.lists(_scalars, max_size=4))
_trees = st.recursive(
    st.dictionaries(_keys, _leaves, max_size=4),
    lambda sub: st.dictionaries(_keys, st.one_of(_leaves, sub), max_size=4),
    max_leaves=24)


@settings(max_examples=300, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(tree=_trees)
def test_round_trip_both_ways(tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rt")
    # JAX's bytes read back through the port
    jax_config.save_config(jax_config.ConfigNode(tree), tmp / "j.yaml")
    assert same(port_config.load_config(tmp / "j.yaml").to_dict(), tree)
    # the port's bytes are JAX's, and read back through yaml.safe_load
    port_config.save_config(port_config.ConfigNode(tree), tmp / "p.yaml")
    text = (tmp / "p.yaml").read_text()
    assert text == (tmp / "j.yaml").read_text()
    assert same(yaml.safe_load(text) or {}, tree)


@pytest.mark.parametrize("text", [
    "", "# a comment only\n", "null\n", "{}\n", "a: 1e-3\n", "a: 1.0e-3\n",
    "a: 1.0e3\n", "a: yes\nb: no\nc: on\nd: Off\ne: ~\nf:\n",
    "a: 800\nb: 20.0\nc: false\nd: -.5\ne: .5\nf: 1_000\ng: -.inf\n",
    "# head\na: 1  # trailing\n  # indented\nb:\n  c: x # y\n",
    'a: ["electronic", "pop", \'it\'\'s\', plain, 3, 4.0, true, null]\n',
    "a: [1, 2,]\nb: [ ]\nc: []\n", "a: [x,\n  'y', z # c\n  ]\n",
    "a:\n- 1\n- x\n  # c\n-\nb:\n  - 'q' # c\n  - \"r\\tq\"\n",
    'a: "x # y" # z\nb: \'p\'#q\n', "a: x\n  y\n\n  z\nb: 'm\n\n  n'\n",
    "a: b:c\nb: :x\nc: 2001:db8\nd: x#y\nkey with  spaces : 1\n",
    "a:\n  b:\n    c:\n      d: [1]\n    e: {}\n",
    '{"a": 1e-3, "b": 1.0e+3, "c": NaN, "d": [1, "x"], "e": {"f": null}}',
])
def test_subset_reads_what_safe_load_reads(text):
    assert same(yaml_subset.load(text), yaml.safe_load(text) or {})


@pytest.mark.parametrize("text, line", [
    ("a: 1\nb: &x 2\n", 2), ("a: 1\nb: *x\n", 2), ("a: !!str 1\n", 1),
    ("a: 1\n---\nb: 2\n", 2), ("---\na: 1\n", 1), ("%YAML 1.1\na: 1\n", 1),
    ("a: 1\nb: |\n  x\n", 2), ("a: >\n  x\n", 1), ("a: 1\n? b\n: 2\n", 2),
    ("a: 0o17\nb: 017\n", 2), ("a: 1\nb: 0x1f\n", 2), ("a: 1:30\n", 1),
    ("a: 1\nb: 2024-01-01\n", 2), ("a:\n  b: 1\n  c: b: c\n", 3),
    ("a: [1, [2]]\n", 1), ("a: [b: c]\n", 1), ("a: {b: 1}\n", 1),
    ("a:\n  - b: 1\n", 2), ("a:\n  - - 1\n", 2), ("a: x\n  # c\n  y\n", 2),
    ("a:\n\tb: 1\n", 2), ("a: x\ty\n", 1), ("a: 'x\n", 1), ("a: [1, 2\n", 1),
    ("a: 1\n- 2\n", 2), ("a: 1\n  b: 2\n", 1), ("yes: 1\n", 1),
    ("a: 1\n<<: {}\n", 2), ('{"a": 1,}', 1),
])
def test_refused_constructs_name_file_and_line(text, line, tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=rf"bad\.yaml: line {line}: "):
        port_config.load_config(path)


def test_save_config_refuses_what_it_cannot_write(tmp_path):
    for tree in ({"a": (1, 2)}, {"a": [[1]]}, {"a": [{"b": 1}]},
                 {1: "x"}, {"a\nb": 1}, {"a": b"x"}):
        with pytest.raises(ValueError):
            port_config.save_config(tree, tmp_path / "x.yaml")
    shared = [1]
    with pytest.raises(ValueError):
        port_config.save_config({"a": shared, "b": shared},
                                tmp_path / "x.yaml")
