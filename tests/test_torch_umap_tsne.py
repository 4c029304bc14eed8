"""The port's UMAP (``analysis/umap_impl.py``) and exact t-SNE
(``analysis/tsne.py``) on the CPU.

UMAP against the JAX package's copy: the kNN (the port's brute force in
torch against sklearn's ``NearestNeighbors`` in JAX's ``_knn``) on
tie-free data (indices equal, distances within 1e-12; on coincident
points sklearn's tree orders ties its own way, so there the port matches
JAX only in being finite: ``test_degenerate_inputs``), the fuzzy graph
within 1e-12, ``find_ab_params`` within 1e-9, and ``fit_transform``
within 1e-6 of the embedding's scale (everything after the kNN is JAX's
code and draws); then each case of JAX's ``tests/test_umap.py``, on the
port.

t-SNE against sklearn 1.9: P within 1e-6 of
``sklearn.manifold._t_sne._joint_probabilities``, the PCA start within
1e-5 of the scale of ``PCA(svd_solver="full")``'s (the same signs);
sklearn's default method is Barnes-Hut, so the embeddings are held by
what t-SNE optimizes: on three Gaussian clusters the final KL within 10%
of sklearn's ``kl_divergence_`` and the trustworthiness at k = 5 within
0.03 of sklearn's embedding's.
"""
import numpy as np
import pytest
import torch

from analysis_port_util import _one_thread  # noqa: F401
from multimodal_edema_prediction_tpu.analysis import umap_impl as J
from multimodal_edema_prediction_tpu_torch.analysis import tsne as T
from multimodal_edema_prediction_tpu_torch.analysis import umap_impl


def _three_clusters(n_per=60, d=12, sep=12.0, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, d))
    centers = centers / np.linalg.norm(centers, axis=1, keepdims=True) * sep
    x = np.concatenate([c + rng.normal(scale=1.0, size=(n_per, d))
                        for c in centers])
    y = np.repeat(np.arange(3), n_per)
    return x, y


@pytest.mark.parametrize("k", [5, 15])
def test_knn_matches_sklearn(k):
    x, _ = _three_clusters(n_per=50)
    idx, dist = umap_impl._knn(x, k)
    jidx, jdist = J._knn(x, k)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(dist, jdist, rtol=0, atol=1e-12)
    # a torch input on its device, in chunks
    idx2, dist2 = umap_impl._knn(torch.as_tensor(x), k, chunk=7)
    np.testing.assert_array_equal(idx2, jidx)
    np.testing.assert_array_equal(dist2, dist)


def test_graph_ab_and_layout_match_jax():
    x, _ = _three_clusters(n_per=50)
    got = umap_impl.fuzzy_simplicial_set(x, 15).toarray()
    want = J.fuzzy_simplicial_set(x, 15).toarray()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for spread, min_dist in ((1.0, 0.1), (1.5, 0.3)):
        np.testing.assert_allclose(
            umap_impl.find_ab_params(spread, min_dist),
            J.find_ab_params(spread, min_dist), rtol=0, atol=1e-9)
    e = umap_impl.UMAP(random_state=3, n_epochs=50).fit_transform(x)
    ej = J.UMAP(random_state=3, n_epochs=50).fit_transform(x)
    assert e.dtype == ej.dtype and e.shape == (150, 2)
    assert np.abs(e - ej).max() <= 1e-6 * np.abs(ej).max()


# JAX's tests/test_umap.py, on the port
def test_find_ab_params_matches_published_defaults():
    a, b = umap_impl.find_ab_params(1.0, 0.1)
    assert a == pytest.approx(1.577, abs=0.05)
    assert b == pytest.approx(0.8951, abs=0.02)


def test_fuzzy_graph_is_symmetric_unit_bounded():
    x, _ = _three_clusters(n_per=25)
    dense = umap_impl.fuzzy_simplicial_set(x, n_neighbors=10).toarray()
    np.testing.assert_allclose(dense, dense.T, atol=1e-12)
    assert dense.min() >= 0.0 and dense.max() <= 1.0 + 1e-12
    assert (dense.max(axis=1) > 0.99).all()


def test_separated_clusters_stay_separated():
    x, y = _three_clusters()
    emb = umap_impl.UMAP(n_components=2, n_neighbors=12,
                         random_state=42).fit_transform(x)
    assert emb.shape == (len(x), 2)
    assert np.isfinite(emb).all()
    cents = np.stack([emb[y == k].mean(axis=0) for k in range(3)])
    intra = max(np.linalg.norm(emb[y == k] - cents[k], axis=1).mean()
                for k in range(3))
    inter = min(np.linalg.norm(cents[i] - cents[j])
                for i in range(3) for j in range(i + 1, 3))
    assert inter > 2.0 * intra, (inter, intra)


def test_deterministic_for_fixed_seed():
    x, _ = _three_clusters(n_per=30)
    e1 = umap_impl.UMAP(random_state=7, n_epochs=60).fit_transform(x)
    e2 = umap_impl.UMAP(random_state=7, n_epochs=60).fit_transform(x)
    np.testing.assert_array_equal(e1, e2)


def test_degenerate_inputs():
    out = umap_impl.UMAP(n_components=2).fit_transform(np.zeros((2, 5)))
    assert out.shape == (2, 2)
    emb = umap_impl.UMAP(random_state=0, n_epochs=30).fit_transform(
        np.zeros((20, 4)))
    assert np.isfinite(emb).all()


def test_projection_plot_uses_the_ports_umap(tmp_path):
    from multimodal_edema_prediction_tpu_torch.analysis import \
        visualize_pathology
    rng = np.random.default_rng(3)
    N, K, d = 24, 3, 16
    data = {"fus_tok": rng.normal(size=(N, K, d)).astype(np.float32),
            "y": rng.integers(0, 2, size=(N, K)).astype(np.float32)}
    out = visualize_pathology.plot_query_token_projection(
        data, [f"label_l{k}" for k in range(K)], str(tmp_path))
    assert out["reducer"] == "umap"
    assert out["raw"].shape == out["centered"].shape == (N * K, 2)
    assert (tmp_path / "fusion_token_umap.png").exists()
    assert (tmp_path / "stage4_projection.png").exists()
    assert visualize_pathology.projection_filename("dual") == \
        "ts_token_umap.png"
    assert visualize_pathology.projection_filename("single") == \
        "stage4_token_umap.png"


def test_tsne_p_and_pca_start_match_sklearn():
    from scipy.spatial.distance import squareform
    from sklearn.decomposition import PCA
    from sklearn.manifold._t_sne import _joint_probabilities
    from sklearn.metrics import pairwise_distances
    x, _ = _three_clusters(n_per=40, d=16, sep=6.0)
    x = x.astype(np.float32)
    for perplexity in (5.0, 30.0):
        want = squareform(_joint_probabilities(
            pairwise_distances(x, squared=True), perplexity, 0))
        got = T.joint_probabilities(torch.as_tensor(x), perplexity).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert abs(got.sum() - 1.0) < 1e-9
    pca = PCA(n_components=2, svd_solver="full").fit_transform(x)\
        .astype(np.float32)
    want = pca / np.std(pca[:, 0]) * 1e-4
    got = T.pca_init(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_tsne_optimizes_as_sklearn_does():
    from sklearn.manifold import TSNE, trustworthiness
    x, y = _three_clusters(n_per=40, d=16, sep=6.0)
    x = x.astype(np.float32)
    ours = T.TSNE(n_components=2, perplexity=20, init="pca", random_state=0)
    emb = ours.fit_transform(x)
    ref = TSNE(n_components=2, perplexity=20, init="pca", random_state=0)
    emb_ref = ref.fit_transform(x)
    assert emb.shape == (120, 2) and emb.dtype == np.float32
    assert np.isfinite(emb).all()
    assert abs(ours.kl_divergence_ - ref.kl_divergence_) <= \
        0.1 * ref.kl_divergence_, (ours.kl_divergence_, ref.kl_divergence_)
    assert abs(trustworthiness(x, emb, n_neighbors=5)
               - trustworthiness(x, emb_ref, n_neighbors=5)) <= 0.03
    cents = np.stack([emb[y == k].mean(axis=0) for k in range(3)])
    assert np.all(np.argmin(((emb[:, None] - cents[None]) ** 2).sum(-1),
                            axis=1) == y)
