"""Training of the port's three models (rec, det, cls) and what they share:
the synthetic renderer, ground-truth maps, checkpoints and the end-to-end
evaluation. Importing the package loads neither PIL nor cv2."""
