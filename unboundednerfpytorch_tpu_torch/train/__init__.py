"""Training: the train step, the stage loop and scene bounds."""
