"""The harness: cells found by name, the window, the traced stretch, the
comparison with the plain reference and the result line."""
