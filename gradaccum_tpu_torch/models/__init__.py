"""The BERT classifier."""
