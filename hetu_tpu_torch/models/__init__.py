"""Models of the port: GPT-2 (training, decode, chunked-prefill decode),
BERT pretraining, Wide & Deep CTR, T5 seq2seq training, XLNet
permutation-LM and Longformer MLM pretraining, ViT and Swin image
classification, MAE and CLIP pretraining, the base Transformer and BART
seq2seq training, BigBird MLM, Transformer-XL and Reformer LMs, and the
CNN zoo (ResNet, VGG, AlexNet, LeNet, the 3-layer CNN, MLP, logistic
regression): every family of ``hetu_tpu/models/``."""
from .gpt2 import (GPT2Config, gpt2_decode_chunked_graph, gpt2_decode_graph,
                   gpt2_lm_graph, gpt2_model, synthetic_lm_batch)
from .bert import (BertConfig, bert_classify_graph, bert_model, bert_pooler,
                   bert_pretrain_graph, synthetic_mlm_batch)
from .common import (masked_lm_loss, merge_heads, patchify,
                     post_ln_encoder_stack, pre_ln_block, split_heads)
from .cnn import (alexnet, cnn_3_layers, lenet, logreg, mlp, resnet,
                  resnet18, resnet34, vgg, vgg16, vgg19)
from .ctr import (dcn_criteo, deepfm_criteo, synthetic_criteo,
                  synthetic_criteo_skewed, validate_cache_parity, wdl_criteo)
from .t5 import (T5Config, synthetic_seq2seq_batch, t5_decoder, t5_encoder,
                 t5_seq2seq_graph)
from .longformer import (LongformerConfig, LongformerSelfAttention,
                         longformer_attention_mask, longformer_mlm_graph,
                         longformer_model, synthetic_mlm_ids)
from .xlnet import (XLNetConfig, perm_masks_from_order, synthetic_plm_batch,
                    xlnet_model, xlnet_plm_graph)
from .vit import (ViTConfig, synthetic_image_batch, vit_classify_graph,
                  vit_model)
from .swin import SwinConfig, swin_classify_graph, swin_model
from .transformer import (TransformerConfig, synthetic_copy_batch,
                          transformer_graph)
from .bart import BartConfig, bart_seq2seq_graph
from .reformer import (ReformerConfig, lsh_attention, reformer_lm_graph,
                       reformer_model)
from .transfoxl import TransfoXLConfig, transfoxl_lm_graph, transfoxl_model
from .clip import CLIPConfig, clip_graph, clip_text_tower, clip_vision_tower
from .mae import MAEConfig, mae_pretrain_graph, synthetic_mae_batch
from .bigbird import (BigBirdConfig, bigbird_attention_mask, bigbird_mlm_graph,
                      bigbird_model)
