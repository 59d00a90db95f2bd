"""Mean host wall of the benchmark's span around
MusicLM.clap_tokens_from_text (tokenizer, RoBERTa, projection, RVQ), one
call a batch, synchronised at its end in the traced run."""


def read(layer):
    from benchmark.readings import mean_span_ms

    return mean_span_ms(layer, "text")
