"""Extraction ops of the PyTorch port against the JAX package and the native
C++ ops, in one process on the CPU: box IoU, fixed-size NMS, ROIAlign, the
host ROIPool bin quantization, the device ROIPool (range-max table) and the
per-class max-confidence NMS. Exact where the op is (NMS, ROIPool, max-conf
selection), within 1e-5 relative for ROIAlign."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_challenge_tpu.extract import native as jax_native
from meme_challenge_tpu.extract import ops as jax_ops
from meme_challenge_tpu.ops.iou import pairwise_iou as jax_pairwise_iou
from meme_challenge_tpu.ops.nms import max_conf_device as jax_max_conf
from meme_challenge_tpu_torch.extract import native, ops
from meme_challenge_tpu_torch.ops.iou import box_area, pairwise_iou
from meme_challenge_tpu_torch.ops.nms import batched_max_conf, max_conf_device


def _random_boxes(rng, n=60, size=200):
    x1 = rng.uniform(0, size * 0.8, n)
    y1 = rng.uniform(0, size * 0.8, n)
    w = rng.uniform(5, size * 0.4, n)
    h = rng.uniform(5, size * 0.4, n)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)
    return boxes, rng.rand(n).astype(np.float32)


def test_native_library_is_the_port_copy():
    """The port's native ops come from its own source, built under
    build/bua_ops/, and agree with the JAX package's library."""
    assert native.SOURCE.endswith("meme_challenge_tpu_torch/extract/csrc/"
                                  "bua_ops.cpp")
    assert native.build_library().startswith(native.BUILD_DIR)
    rng = np.random.RandomState(0)
    boxes, scores = _random_boxes(rng)
    np.testing.assert_array_equal(native.nms(boxes, scores, 0.5),
                                  jax_native.nms(boxes, scores, 0.5))
    assert native.nms(np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                      0.3).shape == (0,)


@pytest.mark.parametrize("zero_union", ["zero", "eps"])
def test_pairwise_iou_matches_jax(zero_union):
    rng = np.random.RandomState(1)
    a, _ = _random_boxes(rng, 17)
    b, _ = _random_boxes(rng, 9)
    # degenerate boxes: zero area, and a negative extent
    a[0] = [5, 5, 5, 5]
    b[0] = [5, 5, 5, 5]
    b[1] = [10, 10, 4, 30]
    got = pairwise_iou(torch.from_numpy(a), torch.from_numpy(b),
                       zero_union=zero_union).numpy()
    want = np.asarray(jax_pairwise_iou(jnp.asarray(a), jnp.asarray(b),
                                       zero_union=zero_union))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 0.0
    self_iou = pairwise_iou(torch.from_numpy(a), zero_union=zero_union)
    np.testing.assert_array_equal(
        self_iou.numpy(), np.asarray(jax_pairwise_iou(
            jnp.asarray(a), zero_union=zero_union)))
    np.testing.assert_array_equal(box_area(torch.from_numpy(b)).numpy()[1],
                                  0.0)
    with pytest.raises(ValueError):
        pairwise_iou(torch.from_numpy(a), zero_union="one")


@pytest.mark.parametrize("n,thresh,max_out", [
    (0, 0.3, 5), (1, 0.3, 4), (40, 0.3, 40), (40, 0.7, 40), (60, 0.5, 12)])
def test_nms_matches_jax_and_native(n, thresh, max_out):
    rng = np.random.RandomState(n)
    boxes, scores = _random_boxes(rng, n)
    idx, mask = ops.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                        thresh, max_out=max_out)
    if n:  # JAX's nms_jax cannot trace an empty argmax
        jidx, jmask = jax_ops.nms_jax(jnp.asarray(boxes),
                                      jnp.asarray(scores), thresh,
                                      max_out=max_out)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert idx.dtype == torch.int32 and idx.shape == (max_out,)
    assert (idx.numpy()[~mask.numpy()] == -1).all()
    np.testing.assert_array_equal(
        idx.numpy()[mask.numpy()],
        native.nms(boxes, scores, thresh)[:max_out])


@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_matches_jax_and_native(aligned):
    rng = np.random.RandomState(2)
    feat = rng.randn(4, 12, 15).astype(np.float32)
    rois = np.array([[4.0, 6.0, 60.0, 70.0],
                     [0.0, 0.0, 30.0, 40.0],
                     [-20.0, -12.0, 150.0, 130.0],   # off the map
                     [10.0, 10.0, 11.0, 11.0]], np.float32)
    got = ops.roi_align(torch.from_numpy(feat), torch.from_numpy(rois),
                        1.0 / 8, (7, 7), sampling_ratio=2,
                        aligned=aligned).numpy()
    want = np.asarray(jax_ops.roi_align_jax(
        jnp.asarray(feat), jnp.asarray(rois), 1.0 / 8, (7, 7),
        sampling_ratio=2, aligned=aligned))
    host = native.roi_align(feat, rois, 1.0 / 8, (7, 7), sampling_ratio=2,
                            aligned=aligned)
    assert got.shape == want.shape == (4, 4, 7, 7)
    scale = np.abs(host).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - host).max() <= 1e-5 * scale


def _pool_rois():
    """ROIs for a 1/16 map: inside, off the map on every side, bin edges on
    exact integers (roi heights 14 and 28 map cells at 14 bins, 21 at every
    other bin), a one-cell ROI, and one larger than the map."""
    return np.array([
        [0.0, 0.0, 200.0, 150.0],
        [10.0, 20.0, 60.0, 90.0],
        [-30.0, -20.0, 40.0, 50.0],
        [100.0, 100.0, 400.0, 400.0],
        [16.0, 16.0, 16.0 * 14, 16.0 * 14],      # 14 × 14 cells: bins of 1
        [0.0, 0.0, 16.0 * 27, 16.0 * 20],        # 28 × 21 cells
        [32.0, 0.0, 32.0 + 16.0 * 13, 16.0 * 27],
        [5.0, 5.0, 6.0, 6.0],
        [-100.0, -90.0, 900.0, 800.0],
        [400.0, 300.0, 480.0, 360.0],            # past the bottom-right
    ], np.float32)


@pytest.mark.parametrize("shape", [(8, 13, 17), (6, 16, 12), (3, 1, 5)])
def test_roi_pool_matches_jax_and_native_exactly(shape):
    rng = np.random.RandomState(3)
    feat = rng.randn(*shape).astype(np.float32)
    rois = _pool_rois()
    got = ops.roi_pool_device(torch.from_numpy(feat), rois, 1.0 / 16,
                              (14, 14)).numpy()
    want = np.asarray(jax_ops.roi_pool_device(
        jnp.asarray(feat.transpose(1, 2, 0)), rois, 1.0 / 16, (14, 14)))
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(
        got, native.roi_pool(feat, rois, 1.0 / 16, (14, 14)))
    # ROIs wholly off the map pool to zero
    assert (got[-1] == 0).all()
    empty = ops.roi_pool_device(torch.from_numpy(feat),
                                np.zeros((0, 4), np.float32), 1.0 / 16,
                                (14, 14))
    assert empty.shape == (0, shape[0], 14, 14)


def test_roi_bin_quantize_matches_jax():
    rois = _pool_rois()
    for got, want in zip(ops.roi_bin_quantize(rois, 1.0 / 16, (14, 14)),
                         jax_ops.roi_bin_quantize(rois, 1.0 / 16, (14, 14))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_roi_pool_table_levels_cover_the_widest_bin():
    """The range-max table holds only the window sizes the widest bin
    needs: at a 600 × 800 image's res4 map (40 × 52) and whole-image ROIs,
    bins span at most 4 cells, so 3 levels a side, not 6."""
    rois = np.array([[0.0, 0.0, 799.0, 599.0]], np.float32)
    _, _, bin_h, bin_w = ops.roi_bin_quantize(rois, 1.0 / 16, (14, 14))
    assert ops._levels(float(bin_h.max()), 40) == 3
    assert ops._levels(float(bin_w.max()), 52) == 3
    assert ops._levels(100.0, 40) == (40).bit_length()
    length = torch.arange(1, 16)
    np.testing.assert_array_equal(
        ops._floor_log2(length, 4).numpy(),
        np.floor(np.log2(np.arange(1, 16))).astype(np.int64))


@pytest.mark.parametrize("class_chunk", [None, 5])
def test_max_conf_device_matches_native_jax_and_host_loop(class_chunk):
    """Per-class NMS max confidence: the port on the CPU equals the native
    single call, JAX ``max_conf_device`` and the per-class host loop,
    bit for bit."""
    rng = np.random.RandomState(4)
    R, C = 57, 12
    boxes = np.abs(rng.randn(R, 4)).astype(np.float32) * 30
    boxes[:, 2:] = boxes[:, :2] + np.abs(
        rng.randn(R, 2)).astype(np.float32) * 40 + 1
    boxes[3] = boxes[7]             # a duplicate box
    boxes[5, 2:] = boxes[5, :2]     # a zero-area box
    cls_prob = rng.rand(R, C).astype(np.float32)
    cls_prob /= cls_prob.sum(1, keepdims=True)
    thresh = 0.3

    host = np.zeros(R, np.float32)
    for c in range(1, C):
        keep = native.nms(boxes, cls_prob[:, c], thresh)
        host[keep] = np.maximum(host[keep], cls_prob[keep, c])

    got = max_conf_device(boxes, cls_prob, thresh, "cpu",
                          class_chunk=class_chunk)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, native.nms_max_conf(boxes, cls_prob,
                                                           thresh))
    np.testing.assert_array_equal(got, jax_max_conf(boxes, cls_prob, thresh))
    one = batched_max_conf(torch.from_numpy(boxes[:1]),
                           torch.from_numpy(cls_prob[:1]), thresh=thresh)
    np.testing.assert_array_equal(one.numpy(), cls_prob[:1, 1:].max(1))
