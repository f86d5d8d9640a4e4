"""Training substrate: AdamW with schedules, clipping and int8 gradient
compression (``optim``), and the step factories (``steps``)."""
