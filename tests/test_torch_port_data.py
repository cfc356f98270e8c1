"""The port's data slice against the JAX package, on the CPU: the per-prompt
stat tracker, the legacy prompt closures, and ``PromptDataset(hf_dataset=)``
through the port's own Arrow reader (``data/arrow_disk.py``, no
``datasets`` / ``pyarrow``) on ``save_to_disk`` exports that the tests
write with ``datasets`` and ``pyarrow``, against the JAX package's
``load_from_disk``; the committed fixture the chip run reads. No JAX model
is built here. Every comparison is exact.
"""

import json
import random
import shutil
from pathlib import Path

import datasets
import numpy as np
import pyarrow as pa
import pytest

from pairwise_sample_optimization_tpu.data import prompt_dataset as jpd
from pairwise_sample_optimization_tpu.data import prompts as jprompts
from pairwise_sample_optimization_tpu.data import stat_tracking as jst
from pairwise_sample_optimization_tpu_torch.data import PromptDataset, arrow_disk
from pairwise_sample_optimization_tpu_torch.data import prompts as tprompts
from pairwise_sample_optimization_tpu_torch.data import stat_tracking as tst
from pairwise_sample_optimization_tpu_torch.data.prompt_dataset import imagereward_prompts_path

FIXTURE = Path(__file__).parent / "fixtures" / "pickapic_test_unique_export"
FIXTURE_PROMPTS = 8  # the first lines of the packaged ImageReward prompts, test_unique split


# ---------------------------------------------------------------------- #
# the per-prompt stat tracker
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("buffer_size, min_count", [(4, 3), (16, 16), (3, 1)],
                         ids=["ring-wraps", "fallback-throughout", "single-count"])
def test_stat_tracker_is_bit_equal_to_jax(buffer_size, min_count):
    """Seven updates of float32 rewards over five prompts (batches larger
    than the ring too): the advantages bit-equal and float32, the stats
    equal, the ring's phase and count the same."""
    r = np.random.default_rng(buffer_size * 10 + min_count)
    port, ref = tst.PerPromptStatTracker(buffer_size, min_count), jst.PerPromptStatTracker(
        buffer_size, min_count)
    names = np.array([f"prompt {i}" for i in range(5)])
    for n in (6, 2, 9, 1, 20, 5, 7):
        prompts = names[r.integers(0, 5, n)]
        rewards = (r.standard_normal(n) * 3 + 1).astype(np.float32)
        got, want = port.update(prompts, rewards), ref.update(prompts, rewards)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert port.get_stats() == ref.get_stats()
    for k, ring in ref.stats.items():
        assert (port.stats[k].head, port.stats[k].count) == (ring.head, ring.count)
        np.testing.assert_array_equal(port.stats[k].valid(), ring.valid())


# ---------------------------------------------------------------------- #
# the legacy prompt closures
# ---------------------------------------------------------------------- #


def _with_assets(monkeypatch, assets):
    for mod in (tprompts, jprompts):
        monkeypatch.setattr(mod, "ASSETS_DIR", str(assets))
        mod._load_lines.cache_clear()


def test_prompt_closures_pick_as_jax_under_the_same_seed(tmp_path, monkeypatch):
    """Every closure of ``PROMPT_FNS`` (the ``imagenet_*`` ranges and
    ``anything_prompt`` through ``PSO_PROMPT_ASSETS``; ``from_file`` on a
    path and with ``low``/``high``) gives JAX's picks after the same
    ``random.seed``."""
    assets = tmp_path / "assets"
    assets.mkdir()
    (assets / "imagenet_classes.txt").write_text(
        "".join(f"class {i}\n" + ("\n" if i % 7 == 0 else "") for i in range(1000)))
    (assets / "anything_prompt.txt").write_text("a cat\n  \na dog \nsnow\n")
    own = tmp_path / "mine.txt"
    own.write_text("one\ntwo\nthree\nfour\n")
    _with_assets(monkeypatch, assets)
    assert sorted(tprompts.PROMPT_FNS) == sorted(jprompts.PROMPT_FNS)
    calls = [(name, ()) for name in tprompts.PROMPT_FNS if name != "from_file"]
    calls += [("from_file", (str(own),)), ("from_file", (str(own), 1, 3)),
              ("from_file", ("anything_prompt.txt", None, 2))]
    for seed in (0, 1, 2):
        for name, args in calls:
            random.seed(seed)
            got = [tprompts.get_prompt_fn(name)(*args) for _ in range(6)]
            random.seed(seed)
            want = [jprompts.get_prompt_fn(name)(*args) for _ in range(6)]
            assert got == want, (name, args)
    assert tprompts._load_lines("anything_prompt.txt") == ("a cat", "a dog", "snow")


def test_prompt_closures_refuse_what_jax_refuses(tmp_path, monkeypatch):
    _with_assets(monkeypatch, tmp_path)
    for mod in (tprompts, jprompts):
        with pytest.raises(KeyError, match="simple_animals"):
            mod.get_prompt_fn("nope")
        with pytest.raises(FileNotFoundError):
            mod.imagenet_dogs()


# ---------------------------------------------------------------------- #
# PromptDataset(hf_dataset=...): the save_to_disk reader
# ---------------------------------------------------------------------- #

CAPTIONS = ["a fox in the snow", "a red bird", "ünïcödé: 狐狸 🦊 — é", "", "x" * 700,
            "a cat", "tab\tand\nnewline"]


def _dataset(captions, string_type="string"):
    """Other columns around the captions (an int, a list, a struct), as a
    real export has."""
    n = len(captions)
    features = datasets.Features({"ranking_id": datasets.Value("int64"),
                                  "tags": datasets.Sequence(datasets.Value("int32")),
                                  "caption": datasets.Value(string_type),
                                  "meta": {"w": datasets.Value("float32"),
                                           "src": datasets.Value("string")}})
    return datasets.Dataset.from_dict(
        {"ranking_id": list(range(n)), "tags": [[i, i + 1] for i in range(n)],
         "caption": captions, "meta": [{"w": 0.5, "src": "s"}] * n}, features=features)


def _rebatch(directory, rows):
    """Rewrite every shard under ``directory`` as record batches of ``rows``."""
    for path in sorted(Path(directory).rglob("*.arrow")):
        table = pa.ipc.open_stream(pa.BufferReader(path.read_bytes())).read_all()
        with pa.OSFile(str(path), "wb") as f:
            with pa.ipc.new_stream(f, table.schema) as w:
                for batch in table.to_batches(max_chunksize=rows):
                    w.write_batch(batch)


def _export(kind, root):
    """(directory, split) of an export of ``kind``."""
    path = root / kind
    caps = CAPTIONS * 3
    split = None
    if kind == "dataset":
        _dataset(caps).save_to_disk(str(path))
    elif kind in ("dict", "missing_split", "empty_split"):
        d = datasets.DatasetDict({"train": _dataset(caps[:5]), "test_unique": _dataset(caps),
                                  "empty": _dataset(caps).filter(lambda row: False)})
        d.save_to_disk(str(path))
        split = {"dict": "test_unique", "missing_split": "validation",
                 "empty_split": "empty"}[kind]
    elif kind == "three_shards":
        _dataset(caps).save_to_disk(str(path), num_shards=3)
    elif kind == "small_batches":
        _dataset(caps).save_to_disk(str(path), num_shards=2)
        _rebatch(path, 2)
    elif kind == "large_string":
        _dataset(caps, "large_string").save_to_disk(str(path))
    elif kind == "nulls":
        _dataset([None, "a", None, None, "b"] * 3 + [None] * 9).save_to_disk(str(path),
                                                                              num_shards=2)
    elif kind == "non_ascii":
        _dataset(["日本語のキャプション", "Ελληνικά", "emoji 🐈‍⬛", "mixed é ß ø"]).save_to_disk(
            str(path))
    return str(path), split


@pytest.mark.parametrize("kind", ["dataset", "dict", "missing_split", "three_shards",
                                  "small_batches", "large_string", "nulls", "non_ascii",
                                  "empty_split"])
def test_hf_dataset_prompts_equal_jax_load_from_disk(tmp_path, kind):
    """``PromptDataset(hf_dataset=dir, split=)`` of the port (its own
    reader) against the JAX package's (``datasets.load_from_disk``): the
    same prompts in the same order, a null as ``"None"``; a single
    ``Dataset`` ignores ``split``; a split the ``DatasetDict`` lacks is a
    ``KeyError`` in both."""
    path, split = _export(kind, tmp_path)
    if kind == "missing_split":
        for cls in (PromptDataset, jpd.PromptDataset):
            with pytest.raises(KeyError, match="validation"):
                cls(hf_dataset=path, split=split)
        return
    want = jpd.PromptDataset(hf_dataset=path, split=split).prompts
    got = PromptDataset(hf_dataset=path, split=split).prompts
    assert got == want
    assert len(got) == {"nulls": 24, "non_ascii": 4, "empty_split": 0}.get(kind, 21)
    if kind == "small_batches":  # the rewritten shards hold many record batches
        shard = next(Path(path).glob("*.arrow"))
        assert sum(1 for _ in pa.ipc.open_stream(str(shard))) > 4
    if kind == "nulls":
        assert got.count("None") == 18
    if kind == "dataset":  # a single Dataset ignores split
        assert PromptDataset(hf_dataset=path, split="anything").prompts == want


def _stream(path, table, **options):
    with pa.OSFile(str(path), "wb") as f:
        with pa.ipc.new_stream(f, table.schema,
                               options=pa.ipc.IpcWriteOptions(**options)) as w:
            w.write_table(table)


@pytest.mark.parametrize("case", ["zstd", "lz4", "dictionary", "missing_column", "int_column"])
def test_reader_refuses_naming_the_file(tmp_path, case):
    """A compressed body, a dictionary-encoded column, a missing column and
    a column that holds no strings are refused with the file's name and
    the reason."""
    caps = pa.array(CAPTIONS)
    path = tmp_path / f"{case}.arrow"
    column = "caption"
    if case in ("zstd", "lz4"):
        _stream(path, pa.table({"caption": caps}), compression=case)
        error, reason = NotImplementedError, "compressed"
    elif case == "dictionary":
        _stream(path, pa.table({"caption": caps.dictionary_encode()}))
        error, reason = NotImplementedError, "dictionary-encoded"
    elif case == "missing_column":
        _stream(path, pa.table({"text": caps}))
        error, reason = KeyError, "no column 'caption'"
    else:
        _stream(path, pa.table({"caption": pa.array(range(7))}))
        error, reason = NotImplementedError, "not utf8"
    with pytest.raises(error, match=f"{case}.arrow.*{reason}"):
        arrow_disk.read_shard_column(str(path), column)


def test_committed_fixture_reads_as_load_from_disk():
    """The export the chip run reads: its ``test_unique`` split in two
    shards holds the first lines of the packaged ImageReward prompts, as
    ``datasets.load_from_disk`` reads them; the ``train`` split too."""
    ref = datasets.load_from_disk(str(FIXTURE))
    assert sorted(ref) == ["test_unique", "train"]
    assert len(json.loads((FIXTURE / "test_unique" / "state.json").read_text())[
        "_data_files"]) == 2
    with open(imagereward_prompts_path()) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for split in ("test_unique", "train"):
        got = arrow_disk.load_column(str(FIXTURE), "caption", split)
        assert got == ref[split]["caption"]
    assert arrow_disk.load_column(str(FIXTURE), "caption", "test_unique") == lines[
        :FIXTURE_PROMPTS]
    assert sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file()) < 16384


def test_a_hub_name_is_refused_with_the_way_out(tmp_path):
    """A source that is not a directory needs the network: refused, naming a
    local export as what to pass."""
    with pytest.raises(NotImplementedError, match="save_to_disk"):
        PromptDataset(hf_dataset="yuvalkirstain/pickapic_v1_no_images")
    copy = tmp_path / "copy"
    shutil.copytree(FIXTURE, copy)
    assert PromptDataset(hf_dataset=str(copy), split="train").prompts == datasets.load_from_disk(
        str(copy))["train"]["caption"]
