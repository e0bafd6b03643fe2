"""Reconstruction metrics: PSNR, SSIM / MS-SSIM, LPIPS (AlexNet), FID over InceptionV3 features, IS."""
