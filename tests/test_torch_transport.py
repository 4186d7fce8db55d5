"""The host-card transport (`geom/transport.py`) on the CPU: the one ring's
bookkeeping as both directions use it, and the counters the benchmark reads
where it reads them. The copies themselves run on the card
(tests/test_torch_cuda.py, tests/test_torch_download_ring.py, marker
`cuda`)."""

import numpy as np
import pytest
import torch

from deep_cartograph_torch.geom import engine, kernels, transport

CPU = torch.device("cpu")
ROUNDS = 2 * transport.RING_SLOTS + 1


def _upload():
    """The copy up: a chunk of 2 frames of 5 atoms, atoms 1 and 3 staged,
    a slot each. Returns (ring, one chunk: its slot, whether it waited,
    the pieces taken: none, the copy up has no queue)."""
    ring = transport.UploadRing(CPU, 2 * 2 * 3)
    atoms = np.array([1, 3], np.int64)

    def one(i):
        frames = np.arange(30, dtype=np.float32).reshape(2, 5, 3) + 100 * i
        coords, k, waited = ring.stage(frames, atoms)
        # the work reads the host slot itself
        assert coords.data_ptr() == ring.host[k].data_ptr()
        assert np.array_equal(coords.numpy(), frames[:, atoms])
        ring.done_reading(k)
        return k, waited

    return ring, one, None


def _download():
    """The copy back: chunks of 2 rows of 3 features, a piece each, the
    pieces taken by the ring as it laps. Returns (ring, one chunk, the
    pieces taken, in the order their sink got them)."""
    ring = transport.DownloadRing(CPU, 3)
    taken = []

    def one(i):
        features = torch.full((2, 3), float(i))
        assert ring.send(features, taken.append) == 1
        k, piece, _ = ring.pending[-1]
        # the piece is the features' rows themselves
        assert piece.data_ptr() == features.data_ptr()
        return k, False

    return ring, one, taken


@pytest.mark.parametrize("direction", [_upload, _download], ids=["up", "down"])
def test_the_ring_hands_out_its_slots_in_turn_and_copies_nothing_on_the_cpu(direction):
    ring, one, taken = direction()
    assert len(ring.host) == transport.RING_SLOTS
    assert not hasattr(ring, "stream") and not hasattr(ring, "copied")
    turns = [one(i) for i in range(ROUNDS)]
    assert [k for k, _ in turns] == [i % transport.RING_SLOTS for i in range(ROUNDS)]
    assert not any(waited for _, waited in turns)
    assert all(not ring.wait(k) for k in range(transport.RING_SLOTS))
    if taken is not None:
        # a full ring gave up its oldest piece before each new one
        assert len(ring) == transport.RING_SLOTS
        ring.take()
        assert [int(piece[0, 0]) for piece in taken] == list(range(ROUNDS - 2))
        assert len(ring) == transport.RING_SLOTS - 1
        ring.discard()
        assert len(ring) == 0
        assert all(slot.numel() == 0 for slot in ring.host)   # no slots on the CPU


def test_the_counters_are_the_ones_the_benchmark_reads():
    """`carto_bench` reads `geom.kernels.UPLOAD_STATS` and
    `geom.engine.DOWNLOAD_STATS`: they are the objects the rings count into."""
    assert kernels.UPLOAD_STATS is transport.UPLOAD_STATS
    assert engine.DOWNLOAD_STATS is transport.DOWNLOAD_STATS
    assert isinstance(transport.UPLOAD_STATS, transport.UploadStats)
    assert isinstance(transport.DOWNLOAD_STATS, transport.DownloadStats)
