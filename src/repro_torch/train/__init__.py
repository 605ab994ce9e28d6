"""Step factories; the serving half (prefill and decode) is ported."""
