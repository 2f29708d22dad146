"""Losses, the SGD chain and the local trainer."""
