"""Training (torch port): the BNN slot models' STE training and the losses."""
