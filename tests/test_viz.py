"""Visualization smoke test: figures produced from real matrices."""

import os

import pytest

REF = "/root/reference"


@pytest.fixture(scope="module")
def viz():
    pytest.importorskip("matplotlib")  # the optional `viz` extra
    from simka_tpu.viz import visualize

    return visualize


@pytest.fixture(scope="module")
def result_dir(tmp_path_factory):
    # use committed truth matrices as input
    src = f"{REF}/tests/truth/results_k21_t2"
    if not os.path.isdir(src):
        pytest.skip("reference not available")
    return src


def test_load_and_pcoa(viz, result_dir):
    ids, mat = viz.load_distance_matrix(
        os.path.join(result_dir, "mat_abundance_braycurtis.csv")
    )
    assert ids == ["A", "B", "C", "D", "E"]
    assert mat.shape == (5, 5)
    coords, expl = viz.pcoa(mat)
    assert coords.shape == (5, 2)
    assert 0 <= expl[0] <= 1


def test_run_visualization(viz, result_dir, tmp_path):
    out = str(tmp_path / "figs")
    files = viz.run_visualization(
        result_dir,
        out,
        metadata_filename=f"{REF}/example/dataset_metadata.csv",
        metadata_variable="VARIABLE_2",
    )
    assert len(files) == 20 * 3  # 20 matrices x 3 figure kinds
    for f in files[:6]:
        assert os.path.getsize(f) > 1000
