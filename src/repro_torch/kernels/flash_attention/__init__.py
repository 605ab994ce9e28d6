"""Forward attention with GQA, causal and sliding-window masks."""
