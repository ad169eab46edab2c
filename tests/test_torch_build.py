"""The kernel library's name follows every file of ``ops/csrc/``: a changed
header must name a new library (the old one would be stale), and the order
the directory lists its files in must not matter.  CPU only: nothing is
compiled, ``source_digest`` only reads the files."""

import shutil

import pytest

from smer_music_generation_tpu_torch.ops import decode_step as ds


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(ds._CSRC, dst)
    return dst


def test_the_shared_header_is_among_the_sources():
    names = {p.name for p in ds._CSRC.iterdir()}
    assert "attn_tiles.cuh" in names
    for src in ("attention.cu", "train_attention.cu", "flash_train.cu"):
        assert '#include "attn_tiles.cuh"' in (ds._CSRC / src).read_text()


def test_digest_changes_when_a_header_changes(csrc_copy):
    before = ds.source_digest(csrc_copy)
    assert before == ds.source_digest(ds._CSRC)
    header = csrc_copy / "attn_tiles.cuh"
    header.write_text(header.read_text() + "\n// one more line\n")
    assert ds.source_digest(csrc_copy) != before


def test_digest_changes_when_a_file_is_added_or_renamed(csrc_copy):
    before = ds.source_digest(csrc_copy)
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    added = ds.source_digest(csrc_copy)
    assert added != before
    (csrc_copy / "extra.cuh").rename(csrc_copy / "other.cuh")
    assert ds.source_digest(csrc_copy) not in (before, added)


def test_digest_does_not_depend_on_file_order(tmp_path):
    """The same files written in two opposite orders (so the directory
    may list them differently) give one digest."""
    files = sorted(p for p in ds._CSRC.iterdir() if p.is_file())
    digests = []
    for tag, order in (("fwd", files), ("rev", files[::-1])):
        dst = tmp_path / tag
        dst.mkdir()
        for p in order:
            (dst / p.name).write_bytes(p.read_bytes())
        digests.append(ds.source_digest(dst))
    assert digests[0] == digests[1] == ds.source_digest(ds._CSRC)
