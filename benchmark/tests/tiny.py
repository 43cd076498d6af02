"""A cell at a size the CPU holds: the served models' layer kinds (GQA under
a sliding window, GRASP pairs in two of four layers) at toy widths."""

from benchmark.harness.spec import Cell

CONFIG = {
    "hidden_act": "silu", "hidden_size": 256, "intermediate_size": 512,
    "max_position_embeddings": 512, "num_attention_heads": 4, "num_hidden_layers": 4,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
    "sliding_window": 256, "tie_word_embeddings": False, "vocab_size": 256,
    "grasp": {"layers_id": [1, 2], "compression_ratio": 0.5},
    "port": {"dtype": "bfloat16", "use_pallas_lowrank": True, "use_flash_attention": True},
}


def traffic(loop: str = "open") -> dict:
    t = {"loop": loop, "max_batch": 4, "page_size": 16,
         "prompt": {"median": 40, "sigma": 0.3, "min": 20, "max": 64},
         "output": {"median": 24, "sigma": 0.3, "min": 12, "max": 40},
         "max_total": None, "length_seed": 7, "check_requests": 6}
    if loop == "open":
        t.update(rate=8.0, warm_seconds=0.5)
    else:
        t.update(clients=4, first_wave_output={"uniform": [2, 10]})
    return t


def cell(loop: str = "open", per_layer=None) -> Cell:
    e2e = [{"name": "output_tok_s", "unit": "tokens/s"}, {"name": "itl_p95_ms", "unit": "ms"},
           {"name": "setup_s", "unit": "s"}]
    if loop == "open":
        e2e.append({"name": "ttft_p90_ms", "unit": "ms"})
    return Cell(name="tiny." + loop, chips=1, config=CONFIG, traffic=traffic(loop),
                end_to_end=e2e, per_layer=per_layer or [])
