"""Input pipeline and tokenization (numpy and pure Python)."""
