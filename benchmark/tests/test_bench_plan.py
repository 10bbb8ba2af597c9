"""The harness is driven by data: a cell added by a traffic file and an
entry is listed and planned with no file of the harness edited."""
import json
import os

from harness import plan as P


def test_a_new_cell_is_planned(bench_copy):
    plan = P.load("cluster-tiny", str(bench_copy))
    assert plan.traffic["n_seqs"] == 400
    assert plan.config["program"] == "cluster"
    assert os.path.exists(plan.path(plan.config["weights"]))
    assert [m.name for m in plan.end_to_end] == ["cluster_seqs_per_s", "setup_s"]
    assert [m.name for m in plan.per_layer] == [
        "job_setup_s", "accumulate_ms_per_step", "update_s",
        "pair_stats_roofline.cluster", "window_step_roofline", "device_idle.cluster"]
    plan = P.load("search-tiny", str(bench_copy))
    assert [m.name for m in plan.end_to_end] == ["search_queries_per_s", "setup_s"]
    assert [m.name for m in plan.per_layer] == [
        "search_host_s", "search_score_s", "pair_stats_roofline.search",
        "device_idle.search"]


def test_the_committed_cells_plan():
    with open(os.path.join(P.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cell in bench["workloads"]:
        plan = P.load(cell["name"])
        assert plan.end_to_end and plan.per_layer
        assert set(plan.config["limits"]) and plan.traffic["pools"] >= 1
        assert plan.traffic["trace_jobs"] >= 1


def test_a_configuration_states_what_its_weights_state(bench_copy):
    # k, id and datatype are the weights file's: a configuration that
    # states another value is refused before any run
    import pytest

    conf = bench_copy / "benchmark" / "configs" / "mc2-tiny.json"
    with open(conf) as f:
        data = json.load(f)
    assert P.weights_header(P.load("cluster-tiny", str(bench_copy)).path(
        data["weights"]))["k"] == str(data["k"])
    for key, value in (("k", 6), ("id", 0.8), ("datatype", "uint16_t")):
        with open(conf, "w") as f:
            json.dump(dict(data, **{key: value}), f)
        with pytest.raises(SystemExit, match=key):
            P.load("cluster-tiny", str(bench_copy))


def test_options_reach_the_argv_and_the_reference(bench_copy):
    # one source: the configuration's options fill the argv's fields and
    # are the reference's arguments
    import inspect

    import reference as R
    for name, ref in (("cluster-tiny", R.cluster), ("search-tiny", R.search_all)):
        config = P.load(name, str(bench_copy)).config
        argv = " ".join(config["argv"])
        for key in config["options"]:
            assert "{" + key + "}" in argv
            assert key in inspect.signature(ref).parameters
