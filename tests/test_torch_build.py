"""The kernels' build cache key (ops/kernels/build.py): a library's file
name carries a hash of its source, the headers beside that source and the
flags. No nvcc is needed: nothing is built."""

from gaussiansplat_tpu_torch.ops.kernels.build import CSRC_DIR, CudaKernel
from gaussiansplat_tpu_torch.ops.kernels.forward import FORWARD


def _tree(root, name, header):
    d = root / name
    d.mkdir()
    (d / "forward.cu").write_text('#include "raster_common.cuh"\n')
    (d / "raster_common.cuh").write_text(header)
    return CudaKernel(str(d / "forward.cu"), "gs_rasterize_forward", [])


def test_headers_beside_the_source_key_the_build(tmp_path):
    # The same .cu with other headers (a parent tree in
    # compare_forward_builds.py) must not reuse this build.
    one = _tree(tmp_path, "one", "// one\n")
    two = _tree(tmp_path, "two", "// two\n")
    assert one.library_path() != two.library_path()
    (tmp_path / "two" / "raster_common.cuh").write_text("// one\n")
    assert one.library_path() == two.library_path()


def test_checkout_headers_do_not_key_another_tree(tmp_path):
    other = _tree(tmp_path, "other", (CSRC_DIR / "raster_common.cuh").read_text())
    (tmp_path / "other" / "forward.cu").write_bytes(FORWARD.source.read_bytes())
    # Same source and same header: the same library as the checkout's ...
    assert other.library_path() == FORWARD.library_path()
    # ... until a header of that tree differs, whatever the checkout holds.
    (tmp_path / "other" / "raster_common.cuh").write_text("// changed\n")
    assert other.library_path() != FORWARD.library_path()


def test_build_all_starts_one_build_per_library(tmp_path, monkeypatch):
    # Two kernels with the same source and headers share one library: one
    # nvcc, whose log both get (two would race on one temporary file).
    from gaussiansplat_tpu_torch.ops.kernels import build

    one = _tree(tmp_path, "one", "// same\n")
    two = _tree(tmp_path, "two", "// same\n")
    started = []

    def fake_start(self):
        started.append(self)
        return "proc"

    def fake_finish(self, proc):
        self.build_log = "ptxas info    : Used 40 registers"

    monkeypatch.setattr(build.CudaKernel, "_start_build", fake_start)
    monkeypatch.setattr(build.CudaKernel, "_finish_build", fake_finish)
    assert build.build_all([one, two]) == [one, two]
    assert started == [one]
    assert two.build_log == one.build_log != ""


def test_defines_key_the_build():
    # A build with -D flags (the raster kernels with the support cull off,
    # tests/test_torch_gpu.py) is another library than the plain build.
    off = CudaKernel(str(FORWARD.source), FORWARD.symbol, FORWARD.argtypes,
                     defines=("GS_NO_SUPPORT_CULL",))
    assert "-DGS_NO_SUPPORT_CULL" in off.flags
    assert off.library_path() != FORWARD.library_path()
    again = CudaKernel(str(FORWARD.source), FORWARD.symbol, FORWARD.argtypes,
                       defines=("GS_NO_SUPPORT_CULL",))
    assert again.library_path() == off.library_path()
