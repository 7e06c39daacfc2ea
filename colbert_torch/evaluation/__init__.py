"""Quality evaluation: IR metrics, dataset runners, the exact oracle and the
operating-point tuner (port of ``colbert_tpu.evaluation``)."""
