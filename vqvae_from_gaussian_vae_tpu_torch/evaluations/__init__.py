"""Reconstruction metrics: PSNR, SSIM / MS-SSIM, LPIPS (AlexNet, VGG16), FID over
InceptionV3 features, IS; FVD over I3D features of clips."""
