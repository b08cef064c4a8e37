"""Decoder blocks (dense and Mamba-1) and language-model assembly."""
