# Training substrate: AdamW with fp32 master weights, the schedule, the
# train step with microbatch gradient accumulation.
