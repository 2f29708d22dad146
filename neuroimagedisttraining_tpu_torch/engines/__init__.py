"""Federated engines (the SalientGrads slice)."""
