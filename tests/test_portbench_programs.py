"""The benchmark's tests of program files found by name and of cells on
several ranks (portbench/tests/test_portbench_programs.py: a sharded
program on two gloo ranks through `run.py` and `readings.py`, a failing
rank, a missing program file), collected here so that the suite under
tests/ runs them."""

import importlib.util
from pathlib import Path

from test_torch_common import limit_torch_threads

limit_torch_threads()

_PATH = (Path(__file__).resolve().parents[1] / "portbench" / "tests"
         / "test_portbench_programs.py")
_spec = importlib.util.spec_from_file_location("portbench_test_programs", _PATH)
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)

root = _mod.root
test_a_cell_on_two_ranks = _mod.test_a_cell_on_two_ranks
test_a_failing_rank_ends_the_job = _mod.test_a_failing_rank_ends_the_job
test_a_missing_program_fails_at_once = _mod.test_a_missing_program_fails_at_once
test_readings_of_a_cell_on_two_ranks = _mod.test_readings_of_a_cell_on_two_ranks
