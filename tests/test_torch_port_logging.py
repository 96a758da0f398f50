"""The port's MetricLogger (`srfdet3d_torch/utils/logging.py`) and its
event-file writer (`utils/event_file.py`) against the JAX package's logger,
which writes through tensorflow.

The same metric sequence through both loggers gives the same (tag, step,
value) triples, exactly (both store float32): the port's file read with
tensorflow's `summary_iterator` (simple_value) and with the port's own
reader, the JAX one's with `summary_iterator` (its tensor summaries
through `tf.make_ndarray`).  The printed lines are equal too.  The CRC is
held against tensorflow's own.
"""

import glob
import os

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from srfdet3d_tpu.utils.logging import MetricLogger as JLogger  # noqa: E402
from srfdet3d_torch.utils import event_file                    # noqa: E402
from srfdet3d_torch.utils.logging import MetricLogger          # noqa: E402

RUNS = [
    (10, {"loss": 3.25, "loss_cls": 1.5, "loss_bbox": 0.75}, 2e-4),
    (15, {"loss": 9.9}, None),                    # off the interval
    (40, {"loss": 1.0}, None),
    (20, {"loss": 2.125, "grad_norm": 1e-7}, 1.9e-4),
    (30, {"loss": float("nan"), "loss_cls": 1e-30}, 0.0),
]
EVAL = (30, {"mAP": 0.4125, "NDS": 0.5, "per_class": {"car": 0.1}})


def drive(logger):
    for step, metrics, lr in RUNS:
        logger.log(step, metrics, lr=lr)
    logger.log_eval(*EVAL)


def tf_triples(path, tensors):
    out = []
    for ev in tf.compat.v1.train.summary_iterator(path):
        for v in ev.summary.value:
            value = (float(tf.make_ndarray(v.tensor)) if tensors
                     else v.simple_value)
            out.append((v.tag, ev.step, np.float32(value)))
    return out


def drop_timing(line):
    return [w for w in line.split("  ") if not w.endswith("ms/iter")]


def norm(triples):
    """Sorted (tag, step, float32 bits): NaN compares by its bits."""
    return sorted((t, s, np.float32(v).tobytes()) for t, s, v in triples)


def test_event_files_match_jax(tmp_path, capsys):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jlog = JLogger(10, log_dir=jdir)
    assert jlog._writer is not None            # tensorflow wrote the file
    drive(jlog)
    jlog._writer.flush()
    jout = capsys.readouterr().out
    tlog = MetricLogger(10, log_dir=tdir)
    drive(tlog)
    tlog.close()
    tout = capsys.readouterr().out
    # the printed lines: the same but for each line's own ms/iter
    assert [drop_timing(ln) for ln in jout.splitlines()] == \
        [drop_timing(ln) for ln in tout.splitlines()]

    (jpath,) = glob.glob(os.path.join(jdir, "events.out.tfevents.*"))
    (tpath,) = glob.glob(os.path.join(tdir, "events.out.tfevents.*"))
    assert tlog.event_path == tpath
    want = norm(tf_triples(jpath, tensors=True))
    # steps 10, 20, 30 with lr; 40 without; eval without per_class
    assert len(want) == 4 + 3 + 3 + 1 + 2
    assert norm(tf_triples(tpath, tensors=False)) == want
    assert norm(event_file.read_scalars(tpath)) == want
    # the first record is the file version, as TensorBoard expects
    first = next(tf.compat.v1.train.summary_iterator(tpath))
    assert first.file_version == "brain.Event:2"


def test_crc_and_framing_match_tensorflow(tmp_path):
    from tensorflow.python.lib.io import tf_record
    path = str(tmp_path / "records")
    payloads = [b"", b"a", bytes(range(256)) * 5, b"\xff" * 1000]
    with open(path, "wb") as f:
        for p in payloads:
            f.write(event_file.frame_record(p))
    assert list(tf_record.tf_record_iterator(path)) == payloads
    assert list(event_file.read_records(path)) == payloads
    assert event_file.crc32c(b"123456789") == 0xE3069283
    with open(path, "r+b") as f:                 # one flipped bit
        f.seek(20)
        b = f.read(1)
        f.seek(20)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(ValueError, match="CRC"):
        list(event_file.read_records(path))


def test_no_log_dir_writes_nothing(tmp_path, capsys):
    log = MetricLogger(1)
    log.log(1, {"loss": 1.0})
    log.close()
    assert log.event_path is None and not os.listdir(tmp_path)
    assert "loss 1.0000" in capsys.readouterr().out
