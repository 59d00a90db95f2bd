"""Mean host wall of the benchmark's span around MusicLM._decode (Encodec),
synchronised at its end in the traced run, per generate call."""


def read(layer):
    from benchmark.readings import mean_span_ms

    return mean_span_ms(layer, "codec")
