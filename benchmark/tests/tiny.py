"""Cells cut to a size the CPU runs in seconds, for the harness's tests."""

from benchmark.harness.spec import load_cell

TINY_MODEL = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
              "intermediate_size": 128}
TINY_TRAFFIC = {
    "search": {"index_rows": 3000, "clients": 12, "query_pool": 256, "warmup_seconds": 0.2,
               "check_requests": 24, "check_longest": 4},
    "score": {"query_pool": 6, "candidates": 10, "queries_per_call": 2, "check_pairs": 16,
              "check_longest": 4, "batch_size": 8,
              "passage_tokens": {"median": 20.0, "sigma": 0.45, "min": 8, "max": 60}},
    "encode": {"passage_pool": 96, "call_passages": 32, "batch_size": 16, "check_passages": 16,
               "check_longest": 4,
               "passage_tokens": {"median": 20.0, "sigma": 0.45, "min": 8, "max": 60}},
    "train": {"max_steps": 40, "warm_steps": 4, "passage_pool": 256, "query_len": 16,
              "doc_len": 32},
}


def tiny_cell(workload: str):
    cell = load_cell(workload)
    cell.config.update(TINY_MODEL)
    if cell.config["model_type"] == "xlm-roberta":
        cell.config["vocab_size"] = 4096
    entry = cell.traffic["entry"]
    cell.traffic.update(TINY_TRAFFIC[entry])
    if entry == "train":
        training = dict(cell.traffic["settings"]["training"], batch_size=4, num_docs_per_query=3)
        cell.traffic["settings"] = dict(cell.traffic["settings"], training=training)
    return cell
