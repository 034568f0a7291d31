"""Entry points, one for each of `skyhdr.cli`, with its flags plus
`--device` (the card by default):

  python -m skyhdr_torch.cli.dataset_generator   the Laval DB -> TFRecords
  python -m skyhdr_torch.cli.train_sun           sun-pose pretrain / eval
  python -m skyhdr_torch.cli.train               the GAN
  python -m skyhdr_torch.cli.inference           LDR panoramas -> HDR maps
  python -m skyhdr_torch.cli.convert_real_eval   real pairs -> TFRecords
  python -m skyhdr_torch.cli.evaluate            PSNR / si-RMSE / EMD
  python -m skyhdr_torch.cli.import_checkpoint   a `skyhdr` checkpoint -> the port's
"""
