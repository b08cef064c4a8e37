"""Dense decoder blocks and language-model assembly."""
