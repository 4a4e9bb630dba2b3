"""The share (%) of the Kimi-VL retrieval eval calls' time that
``inference_retrieval``'s loop waited on its loader threads (its
``stage_stats["data_wait_s"]``)."""


def read(run):
    stats = run.get("stats", {})
    if "data_wait_s" not in stats or stats.get("calls_wall_s", 0) <= 0:
        return None
    return 100.0 * stats["data_wait_s"] / stats["calls_wall_s"]
