"""The port's record path held against the JAX package, on the CPU.

The same inputs through both packages, at 32x32 and 64x64 images and tens
of records: the CRC (the port's host library and its Python loop against
the JAX package's Python and native CRC), tf.Example bytes, TFRecord
files, pose_env's jpeg records, parsed batches and the record generators'
streams are bit-identical; each side reads what the other wrote; and the
port's predictor serves records as it serves the parsed arrays.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
torch.set_num_threads(1)

from tensor2robot_tpu.data import (  # noqa: E402
    default_input_generator as jax_generators,
    example_proto as jax_proto,
    native as jax_native,
    parser as jax_parser,
    tfrecord as jax_tfrecord,
)
from tensor2robot_tpu.research.pose_env import (  # noqa: E402
    pose_env as jax_pose_env,
)
from tensor2robot_tpu.specs import tensorspec_utils as jax_ts  # noqa: E402
from tensor2robot_tpu.utils import image as jax_image  # noqa: E402

from tensor2robot_tpu_torch import modes  # noqa: E402
from tensor2robot_tpu_torch.data import (  # noqa: E402
    default_input_generator as generators,
    example_proto,
    parser,
    tfrecord,
)
from tensor2robot_tpu_torch.predictors.exported_model_predictor import (  # noqa: E402
    ExportedModelPredictor,
)
from tensor2robot_tpu_torch.research.pose_env import (  # noqa: E402
    pose_env,
    pose_env_models,
)
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts  # noqa: E402
from tensor2robot_tpu_torch.utils import image  # noqa: E402

EPISODES = 32


def _buffer(n: int) -> bytes:
  return np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()


def _struct_equal(got, want):
  assert list(got.keys()) == list(want.keys())
  for key in want:
    assert got[key].dtype == want[key].dtype, key
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.fixture(scope="module")
def pose_records(tmp_path_factory):
  """pose_env's jpeg records, written once by each package."""
  root = tmp_path_factory.mktemp("pose_records")
  port_path = pose_env.write_tfrecords(str(root / "port.tfrecord"),
                                       EPISODES, seed=3)
  jax_path = jax_pose_env.write_tfrecords(str(root / "jax.tfrecord"),
                                          EPISODES, seed=3)
  return port_path, jax_path


def _pose_spec(size=64):
  """pose_env's record spec: the preprocessor's in-specs."""
  features = ts.TensorSpecStruct({"image": ts.ExtendedTensorSpec(
      (size, size, 3), np.uint8, name="image", data_format="jpeg")})
  labels = ts.TensorSpecStruct({"target_pose": ts.ExtendedTensorSpec(
      (2,), np.float32, name="target_pose")})
  return features, labels


def _jax_spec(port_struct):
  return jax_ts.TensorSpecStruct(
      (key, jax_ts.ExtendedTensorSpec(**spec.to_json_dict()))
      for key, spec in port_struct.items())


class TestCrc:

  @pytest.mark.parametrize("size", [0, 1, 7, 1001, 1 << 20])
  def test_crcs_agree(self, size):
    data = _buffer(size)
    want = jax_tfrecord.crc32c(data)
    assert tfrecord.crc32c(data) == want
    assert tfrecord.crc32c_reference(data) == want
    masked = jax_tfrecord.masked_crc32c(data)
    assert tfrecord.masked_crc32c(data) == masked
    assert tfrecord.masked_crc32c_reference(data) == masked
    assert jax_native.get_native().masked_crc32c(data) == masked


class TestExampleProto:

  FEATURES = {
      "bytes": [b"\x00\xffjpeg", b"", "text"],
      "floats": [0.5, -1.25, 3e-8, np.float32(7.0)],
      "ints": [0, 1, -1, 2 ** 62, -(2 ** 63), np.int64(-5)],
      "empty": [],
  }

  def test_bytes_equal_and_cross_decode(self):
    port = example_proto.encode_example(self.FEATURES)
    want = jax_proto.encode_example(self.FEATURES)
    assert port == want
    assert example_proto.decode_example(want) == jax_proto.decode_example(
        port)
    decoded = example_proto.decode_example(port)
    assert decoded["ints"] == [0, 1, -1, 2 ** 62, -(2 ** 63), -5]
    assert decoded["empty"] == []

  def test_varints(self):
    for value in (0, 1, 127, 128, 300, 2 ** 63 - 1, -1, -(2 ** 63)):
      out, want = bytearray(), bytearray()
      example_proto._write_varint(out, value)
      jax_proto._write_varint(want, value)
      assert out == want
      read, _ = example_proto._read_varint(bytes(out), 0)
      assert example_proto._signed64(read) == value


class TestTFRecord:

  def test_files_byte_identical_and_cross_read(self, tmp_path):
    records = [_buffer(n) for n in (0, 1, 13, 4096)]
    port_path, jax_path = str(tmp_path / "port"), str(tmp_path / "jax")
    tfrecord.write_tfrecords(port_path, records)
    jax_tfrecord.write_tfrecords(jax_path, records)
    with open(port_path, "rb") as f, open(jax_path, "rb") as g:
      assert f.read() == g.read()
    assert list(tfrecord.read_tfrecords(jax_path)) == records
    assert list(jax_tfrecord.read_tfrecords(port_path)) == records
    assert list(tfrecord.read_tfrecords(jax_path, python_crc=True)) == (
        records)
    python_path = str(tmp_path / "python")
    tfrecord.write_tfrecords(python_path, records, python_crc=True)
    with open(python_path, "rb") as f, open(port_path, "rb") as g:
      assert f.read() == g.read()

  @pytest.mark.parametrize("offset, what", [(3, "length"), (20, "data")])
  def test_flipped_byte_raises_in_both(self, tmp_path, offset, what):
    path = str(tmp_path / "records")
    tfrecord.write_tfrecords(path, [_buffer(64)])
    with open(path, "r+b") as f:
      f.seek(offset)
      byte = f.read(1)
      f.seek(offset)
      f.write(bytes([byte[0] ^ 0x10]))
    match = f"corrupted record {what}"
    with pytest.raises(ValueError, match=match):
      list(tfrecord.read_tfrecords(path))
    with pytest.raises(ValueError, match=match):
      list(tfrecord.read_tfrecords(path, python_crc=True))
    with pytest.raises(ValueError, match=match):
      list(jax_tfrecord.read_tfrecords(path))

  def test_list_files(self, tmp_path):
    for name in ("b.tfrecord", "a.tfrecord"):
      (tmp_path / name).write_bytes(b"")
    pattern = str(tmp_path / "*.tfrecord")
    assert tfrecord.list_files(pattern) == jax_tfrecord.list_files(pattern)
    with pytest.raises(FileNotFoundError):
      tfrecord.list_files(str(tmp_path / "none-*"))

  def test_pose_env_records_byte_identical(self, pose_records):
    port_path, jax_path = pose_records
    with open(port_path, "rb") as f, open(jax_path, "rb") as g:
      assert f.read() == g.read()


class TestImage:

  def test_encodes_equal(self):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (32, 32, 3), np.uint8)
    gray = rng.random((16, 16, 1)).astype(np.float32)
    assert image.encode_jpeg(rgb) == jax_image.encode_jpeg(rgb)
    assert image.encode_jpeg(rgb, quality=60) == jax_image.encode_jpeg(
        rgb, quality=60)
    assert image.encode_png(gray) == jax_image.encode_png(gray)
    np.testing.assert_array_equal(image.to_uint8(gray),
                                  jax_image.to_uint8(gray))
    np.testing.assert_array_equal(
        image.decode_jpeg(image.encode_jpeg(rgb)),
        jax_image.decode_jpeg(image.encode_jpeg(rgb)))
    np.testing.assert_array_equal(image.decode_image(image.encode_png(rgb)),
                                  rgb)


class TestParser:

  @pytest.mark.parametrize("jax_native_on", [True, False])
  def test_pose_batches_bit_identical(self, pose_records, jax_native_on):
    records = list(tfrecord.read_tfrecords(pose_records[0]))
    features, labels = _pose_spec()
    port = parser.ExampleParser(features, labels)
    reference = jax_parser.ExampleParser(_jax_spec(features),
                                         _jax_spec(labels))
    reference.set_native_enabled(jax_native_on)
    got = port.parse_batch(records)
    want = reference.parse_batch(records)
    _struct_equal(got[0], want[0])
    _struct_equal(got[1], want[1])
    assert got[0]["image"].shape == (EPISODES, 64, 64, 3)

  def test_schema_equal(self):
    features, labels = _pose_spec()
    port = parser.ExampleParser(features, labels).schema
    want = jax_parser.ExampleParser(_jax_spec(features),
                                    _jax_spec(labels)).schema
    assert list(port) == list(want)
    for name in want:
      assert port[name].__dict__ == want[name].__dict__

  def _both(self, spec):
    port = parser.ExampleParser(spec)
    reference = jax_parser.ExampleParser(_jax_spec(spec))
    reference.set_native_enabled(False)
    return port, reference

  def test_raw_bytes_png_gray_and_varlen(self):
    rng = np.random.default_rng(1)
    grays = rng.integers(0, 256, (3, 8, 8, 3), np.uint8)
    raw = rng.standard_normal((3, 2, 3)).astype(np.float32)
    records = [example_proto.encode_example({
        "gray": [image.encode_png(grays[i])],
        "raw": [raw[i].tobytes()],
        "seq": list(range(2 * (i + 1))),
        "dense": [float(i), -float(i)],
    }) for i in range(3)]
    spec = ts.TensorSpecStruct({
        "gray": ts.ExtendedTensorSpec((8, 8, 1), np.uint8, name="gray",
                                      data_format="png"),
        "raw": ts.ExtendedTensorSpec((2, 3), np.float32, name="raw"),
        "seq": ts.ExtendedTensorSpec((3, 2), np.int64, name="seq",
                                     is_sequence=True,
                                     varlen_default_value=-1),
        "dense": ts.ExtendedTensorSpec((2,), np.float32, name="dense"),
    })
    port, reference = self._both(spec)
    got, _ = port.parse_batch(records)
    want, _ = reference.parse_batch(records)
    _struct_equal(got, want)
    np.testing.assert_array_equal(got["raw"], raw)
    assert got["seq"][0].tolist() == [[0, 1], [-1, -1], [-1, -1]]

  @pytest.mark.parametrize("case", ["missing", "shape", "optional"])
  def test_errors_match(self, case):
    spec = ts.TensorSpecStruct({
        "x": ts.ExtendedTensorSpec((2,), np.float32, name="x"),
        "o": ts.ExtendedTensorSpec((1,), np.float32, name="o",
                                   is_optional=True)})
    if case == "missing":
      records = [example_proto.encode_example({"o": [1.0]})]
    elif case == "shape":
      records = [example_proto.encode_example({"x": [1.0, 2.0, 3.0]})]
    else:
      records = [example_proto.encode_example({"x": [1.0, 2.0], "o": [1.0]}),
                 example_proto.encode_example({"x": [1.0, 2.0]})]
    port, reference = self._both(spec)
    with pytest.raises(ValueError) as want:
      reference.parse_batch(records)
    with pytest.raises(ValueError) as got:
      port.parse_batch(records)
    assert str(got.value) == str(want.value)

  def test_only_the_python_parser(self):
    features, labels = _pose_spec()
    port = parser.ExampleParser(features, labels)
    port.set_native_enabled(False)
    port.set_native_enabled(None)
    with pytest.raises(ValueError, match="no native parser"):
      port.set_native_enabled(True)
    assert port.calibrate_native([])["decision"] == "python"


@pytest.fixture(scope="module")
def shard_files(tmp_path_factory):
  """Two files of 40 pose_env records each (32x32), seeds 5 and 6."""
  root = tmp_path_factory.mktemp("shards")
  return [pose_env.write_tfrecords(str(root / f"shard-{i}.tfrecord"), 40,
                                   seed=5 + i, image_size=32)
          for i in range(2)]


def _take(generator, mode, n):
  iterator = generator.create_dataset_fn(mode)()
  batches = [next(iterator) for _ in range(n)]
  iterator.close()
  return batches


def _stream_pair(port_cls, jax_cls, mode, n, args=(), **kwargs):
  features, labels = _pose_spec(32)
  port = port_cls(*args, native_mode="python", **kwargs)
  port.set_specification(features, labels)
  reference = jax_cls(*args, native_mode="python", **kwargs)
  reference.set_specification(_jax_spec(features), _jax_spec(labels))
  return _take(port, mode, n), _take(reference, mode, n), port


class TestGenerators:

  @pytest.mark.parametrize("shard_index", [0, 1])
  def test_default_train_stream(self, shard_files, shard_index):
    pattern = ",".join(shard_files)
    got, want, port = _stream_pair(
        generators.DefaultRecordInputGenerator,
        jax_generators.DefaultRecordInputGenerator, modes.TRAIN, 12,
        args=(pattern,), batch_size=8, shuffle_buffer_size=16, seed=3,
        shard_index=shard_index, num_shards=2)
    for (gf, gl), (wf, wl) in zip(got, want):
      _struct_equal(gf, wf)
      _struct_equal(gl, wl)
    assert port.pipeline_stats["native_calibration"]["decision"] == "python"

  def test_default_eval_one_pass(self, shard_files):
    features, labels = _pose_spec(32)
    port = generators.DefaultRecordInputGenerator(
        ",".join(shard_files), batch_size=12)
    port.set_specification(features, labels)
    reference = jax_generators.DefaultRecordInputGenerator(
        ",".join(shard_files), batch_size=12, native_mode="python")
    reference.set_specification(_jax_spec(features), _jax_spec(labels))
    got = list(port.create_dataset_fn(modes.EVAL)())
    want = list(reference.create_dataset_fn(modes.EVAL)())
    assert len(got) == len(want) == 6  # 80 records, 8 dropped
    for (gf, gl), (wf, wl) in zip(got, want):
      _struct_equal(gf, wf)
      _struct_equal(gl, wl)

  def test_fractional_stream(self, shard_files):
    got, want, _ = _stream_pair(
        generators.FractionalRecordInputGenerator,
        jax_generators.FractionalRecordInputGenerator, modes.TRAIN, 8,
        args=(",".join(shard_files),), file_fraction=0.5, batch_size=8,
        shuffle_buffer_size=16, seed=1)
    for (gf, gl), (wf, wl) in zip(got, want):
      _struct_equal(gf, wf)
      _struct_equal(gl, wl)

  @pytest.mark.parametrize("mode", [modes.TRAIN, modes.EVAL])
  def test_weighted_stream(self, shard_files, mode):
    got, want, _ = _stream_pair(
        generators.WeightedRecordInputGenerator,
        jax_generators.WeightedRecordInputGenerator, mode, 9,
        args=(shard_files,), weights=[0.7, 0.3], batch_size=8, seed=2)
    for (gf, gl), (wf, wl) in zip(got, want):
      _struct_equal(gf, wf)
      _struct_equal(gl, wl)

  def test_native_mode_raises(self, shard_files):
    with pytest.raises(ValueError, match="no native parser"):
      generators.DefaultRecordInputGenerator(shard_files[0],
                                             native_mode="native")
    with pytest.raises(ValueError, match="no native parser"):
      generators.WeightedRecordInputGenerator(shard_files,
                                              native_mode="native")

  def test_abandoned_iterator_stops_the_reader(self, shard_files):
    features, labels = _pose_spec(32)
    generator = generators.DefaultRecordInputGenerator(
        shard_files[0], batch_size=4, prefetch_batches=1)
    generator.set_specification(features, labels)
    before = set(threading.enumerate())
    iterator = generator.create_dataset_fn(modes.TRAIN)()
    next(iterator)
    readers = [t for t in set(threading.enumerate()) - before
               if t.name == "t2r-reader"]
    assert len(readers) == 1
    iterator.close()
    readers[0].join(timeout=2.0)
    assert not readers[0].is_alive()


def test_predict_examples_equals_predict(pose_records, tmp_path):
  """Records through predict_examples give what the parsed, preprocessed
  arrays give through predict, bit for bit."""
  model = pose_env_models.PoseEnvRegressionModel(compute_dtype=torch.float32)
  predictor = ExportedModelPredictor(model, str(tmp_path), device="cpu")
  predictor.init_randomly()
  records = list(tfrecord.read_tfrecords(pose_records[0]))[:8]
  preprocessor = model.preprocessor
  features, _ = parser.ExampleParser(
      preprocessor.get_in_feature_specification(modes.PREDICT)).parse_batch(
          records)
  assert features["image"].dtype == np.uint8
  model_ready, _ = preprocessor.preprocess(features, None, modes.PREDICT)
  want = predictor.predict(model_ready)["inference_output"]
  got = predictor.predict_examples(records)["inference_output"]
  assert got.shape == (8, 2)
  np.testing.assert_array_equal(got, want)
